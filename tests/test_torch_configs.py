"""The port's architecture registry (``repro_torch.configs``) against the JAX
package's (``repro.configs``): every arch's fields equal, the dtype as the
torch dtype; the dense archs' parameter counts equal JAX's, computed from
shapes alone; the MoE and SSM archs' counts raise, naming the ROADMAP item
that ports their layers."""

import dataclasses

import pytest
import torch

from repro import configs as jc
from repro.configs.paper_megopolis import PAPER as JAX_PAPER
from repro_torch import configs as tc
from repro_torch import convert
from repro_torch.configs.paper_megopolis import PAPER

DENSE = [a for a in tc.ARCH_IDS if jc.get_arch(a).family not in ("moe", "hybrid", "ssm")]
WAITING = {"dbrx_132b": "A11b", "llama4_maverick_400b_a17b": "A11b", "zamba2_2_7b": "A11c",
           "mamba2_1_3b": "A11c"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: under the suite's parallel
    workers, OpenMP's spinning threads of every worker's small ops contend
    for the same cores (a 0.6 s test took 35 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_registry_names():
    assert tc.ARCH_IDS == jc.ARCH_IDS
    assert tc.list_archs() == jc.list_archs()
    assert tc.get_arch("qwen3-0.6b") is tc.get_arch("qwen3_0_6b")
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_arch("gpt-2")


@pytest.mark.parametrize("arch_id", tc.ARCH_IDS)
def test_arch_fields_equal_jax(arch_id):
    jax_arch, arch = jc.get_arch(arch_id), tc.get_arch(arch_id)
    for field in dataclasses.fields(arch):
        got, want = getattr(arch, field.name), getattr(jax_arch, field.name)
        if field.name in ("model", "smoke"):
            assert got == convert.model_config_from_jax(want), field.name
            assert got.dtype in (torch.bfloat16, torch.float32)
        else:
            assert got == want, field.name


@pytest.mark.parametrize("arch_id", DENSE)
def test_dense_num_params_equal_jax(arch_id):
    arch, jax_arch = tc.get_arch(arch_id), jc.get_arch(arch_id)
    assert arch.model.num_params() == jax_arch.model.num_params()
    assert arch.model.num_active_params() == jax_arch.model.num_active_params()
    assert arch.smoke.num_params() == jax_arch.smoke.num_params()


def test_qwen3_full_width_size():
    """Path G's model: 751.6 M parameters, 3.0 GB in float32."""
    cfg = tc.get_arch("qwen3-0.6b").model
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (28, 1024, 16, 8, 128, 3072, 151936)
    assert cfg.num_params() == 751_632_384


@pytest.mark.parametrize("arch_id", sorted(WAITING))
def test_moe_and_ssm_counts_name_their_item(arch_id):
    cfg = tc.get_arch(arch_id).model
    for count in (cfg.num_params, cfg.num_active_params):
        with pytest.raises(NotImplementedError, match=f"item {WAITING[arch_id]}"):
            count()


def test_shapes_and_paper_config_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jc.SHAPES.items()}
    for arch_id in tc.ARCH_IDS:
        assert tc.applicable_shapes(tc.get_arch(arch_id)) == \
            jc.applicable_shapes(jc.get_arch(arch_id))
    assert dataclasses.asdict(PAPER) == dataclasses.asdict(JAX_PAPER)
    assert dataclasses.asdict(type(PAPER).ci()) == dataclasses.asdict(type(JAX_PAPER).ci())
