"""The port's synthetic LM stream (``repro_torch.data``) against
``repro.data`` on the CPU: the tokens equal the JAX package's bit for bit
(no tolerance) at every ``(seed, step, row range)``, for row slices, for a
vocab below the 16-token head and for Qwen3's 151936, and where the lane
``row·(S+1) + pos`` wraps mod 2^32."""

import numpy as np
import pytest
import torch

from repro.data import SyntheticLMStream as JaxStream
from repro_torch.data import SyntheticLMStream

# (vocab, seq_len, global_batch, seed, step, row_lo, row_hi)
CASES = [
    (512, 32, 4, 0, 0, 0, 4),
    (512, 32, 8, 0x5EED, 17, 3, 7),
    (7, 16, 3, 3, 2, 1, 3),  # vocab below the head: the head wraps mod V
    (1, 8, 2, 9, 4, 0, 2),
    (151936, 2048, 8, 0x5EED, 5, 2, 7),
    (151936, 128, 16, 0xFFFFFFFF, (1 << 32) - 1, 0, 16),
    # rows·(S+1) passes 2^32: the lane wraps as uint32
    (151936, (1 << 20) - 1, 8192, 1, 3, 8190, 8192),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's parallel workers, OpenMP's
    spinning threads of every worker's small ops contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("vocab,seq,batch,seed,step,lo,hi", CASES)
def test_stream_is_the_jax_stream_bit_for_bit(vocab, seq, batch, seed, step, lo, hi):
    want = JaxStream(vocab, seq, batch, seed).batch(step, lo, hi)
    got = SyntheticLMStream(vocab, seq, batch, seed).batch(step, lo, hi, device="cpu")
    for k in ("inputs", "targets"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("step", [0, 11])
def test_stream_is_jax_batch_on_the_device_side(step):
    """The device-side twin: ``jax_batch`` (traced values) gives the same."""
    want = JaxStream(512, 24, 6, 21).jax_batch(step, 1, 5)
    got = SyntheticLMStream(512, 24, 6, 21).batch(step, 1, 5, device="cpu")
    for k in ("inputs", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_row_slices_tile_the_global_batch():
    stream = SyntheticLMStream(1000, 64, 8, seed=5)
    whole = stream.batch(3, device="cpu")
    parts = [stream.batch(3, lo, lo + 2, device="cpu") for lo in range(0, 8, 2)]
    for k in ("inputs", "targets"):
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k])
    # next-token targets: the inputs shifted by one within a generated row
    assert torch.equal(whole["inputs"][:, 1:], whole["targets"][:, :-1])


def test_head_heavy_mixture():
    """About 3/4 of the tokens fall in the 16-token head."""
    toks = SyntheticLMStream(151936, 512, 16, seed=0).batch(0, device="cpu")["inputs"]
    share = float((toks < 16).float().mean())
    assert 0.72 < share < 0.78, share


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="device='cuda'"):
        SyntheticLMStream(512, 32, 4).batch(0)
