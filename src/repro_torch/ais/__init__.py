"""AIS, the paper's adaptive-importance-sampling workload (DESIGN.md §10),
after ``repro.ais``: annealed SMC over tempered targets with analytic logZ
ground truth, resampling through any ``ResamplerSpec`` on either backend."""

from repro_torch.ais.moves import (  # noqa: F401
    MOVES,
    TARGET_ACCEPT,
    adapt_step_size,
    mala,
    random_walk_metropolis,
)
from repro_torch.ais.sampler import (  # noqa: F401
    SMCSamplerConfig,
    run_smc_sampler,
    run_smc_sampler_bank,
)
from repro_torch.ais.schedule import (  # noqa: F401
    conditional_ess,
    geometric_schedule,
    next_temperature,
)
from repro_torch.ais.targets import (  # noqa: F401
    Target,
    banana,
    correlated_gaussian,
    gaussian_family,
    gaussian_mixture,
    gaussian_theta,
    isotropic_gaussian,
    logistic_regression,
)
