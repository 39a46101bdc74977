"""The paper's own experimental configuration (§5-§7).

Used by the benchmark harness so every figure/table reproduction reads its
settings from one place.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    # §5: weight generation
    y_values: tuple = (0.0, 1.0, 2.0, 3.0, 4.0)  # Gaussian-likelihood (eq. 12)
    gamma_alphas: tuple = (0.5, 2.0, 3.0, 10.0, 50.0)  # Gamma (eq. 13)
    particle_range: tuple = tuple(2**e for e in range(6, 23))  # 2^6 .. 2^22
    num_weight_sequences: int = 16
    monte_carlo_runs: int = 256  # K
    epsilon: float = 0.01  # error bound for B (eq. 3)
    # §6.4: C1/C2 partition sweep
    partition_sizes: tuple = (128, 256, 512, 1024, 2048)  # bytes
    # §7: end-to-end UNGM benchmark
    e2e_particles: int = 2**20
    e2e_time_steps: int = 100
    e2e_trajectories: int = 16
    e2e_mc_runs: int = 50
    e2e_b_values: tuple = (5, 7, 10, 15, 20, 25, 30, 40)
    e2e_b_compare: tuple = (16, 32, 64)  # Table 2
    e2e_epsilon: float = 0.1

    # CI-scale variant: same structure, laptop-runnable sizes.  Full paper
    # sizes are available behind --full in benchmarks.
    @staticmethod
    def ci():
        return PaperConfig(
            particle_range=tuple(2**e for e in range(6, 17)),
            num_weight_sequences=4,
            monte_carlo_runs=32,
            e2e_particles=2**14,
            e2e_trajectories=2,
            e2e_mc_runs=4,
        )


PAPER = PaperConfig()
