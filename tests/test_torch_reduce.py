"""The row reduction of the adaptive AIS schedule (``kernels/reduce``) on the
CPU: its plain version ``logsumexp_rows_ref`` gives a bank row the bits of
the same row reduced alone (the order of adds depends on N, never on S),
agrees with ``torch.logsumexp`` to float32 rounding and keeps its
non-finite cases; the wrapper runs it on a CPU tensor and counts no launch.
The kernel is held to it bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 4)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.reduce import reduce as rk
from repro_torch.kernels.reduce.ops import logsumexp
from repro_torch.kernels.reduce.ref import LSE_NT, logsumexp_rows_ref

#: Agreement with ``torch.logsumexp``, whose sums run in another order.
LSE_RTOL = 1e-6


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


@pytest.mark.parametrize("s", (1, 4, 16))
@pytest.mark.parametrize("n", (3, 1000, 4 * LSE_NT + 5, 20000))
def test_bank_row_equals_its_single_row(s, n):
    rng = np.random.default_rng(s * 100003 + n)
    x = torch.from_numpy((rng.standard_normal((s, n)) * 8.0).astype(np.float32))
    bank = logsumexp_rows_ref(x)
    for i in range(s):
        assert torch.equal(_bits(logsumexp_rows_ref(x[i:i + 1])), _bits(bank[i:i + 1]))
    torch.testing.assert_close(bank, torch.logsumexp(x, dim=-1), rtol=LSE_RTOL, atol=0)


def _chain_order(x: np.ndarray) -> np.ndarray:
    """The kernel's order written out lane by lane in numpy float32, apart
    from ``ref.py``: chain t < 1024 adds exp(x - shift) of its quads t, t +
    1024, ... lane by lane; warp w halves chains 32w ... 32w + 31 (lane l
    takes lane l + 16, then l + 8, ...); the 32 warps' sums are added in
    warp order.  exp and log are torch's, as the plain version's: the test
    is of the adds."""
    f32, tiny = np.float32, np.finfo(np.float32).tiny

    def flush(v):
        return np.where(np.abs(v) < tiny, np.zeros_like(v), v).astype(np.float32)

    out = []
    for row in flush(x):
        n, m = row.shape[0], row.max()
        shift = m if np.isfinite(m) else f32(0)
        e = flush(torch.exp(torch.from_numpy(flush(row - shift))).numpy())
        warps = []
        for w in range(LSE_NT // 32):
            lanes = []
            for t in range(32 * w, 32 * w + 32):
                acc = f32(0)
                for q in range(t, -(-n // 4), LSE_NT):
                    for i in range(4 * q, min(4 * q + 4, n)):
                        acc = f32(acc + e[i])
                lanes.append(acc)
            off = 16
            while off:
                lanes = [f32(lanes[i] + lanes[i + off]) if i < off else lanes[i]
                         for i in range(32)]
                off //= 2
            warps.append(lanes[0])
        total = warps[0]
        for v in warps[1:]:
            total = f32(total + v)
        log = flush(torch.log(torch.tensor([total])).numpy())[0]
        out.append(flush(np.array([shift + log], dtype=np.float32))[0])
    return np.array(out, dtype=np.float32)


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("n", (2 * 4 * LSE_NT + 5, 3 * 4 * LSE_NT))
def test_plain_version_is_the_chain_order(seed, n):
    # Rows 0 and 2: one 0 over terms near exp(-14), whose sum lies in the
    # last bits of the result and moves with the order of the adds (the
    # order of chains of 512 moves it by hundreds of ulps).
    rng = np.random.default_rng(seed * 7919 + n)
    x = (rng.standard_normal((3, n)) - 14.0).astype(np.float32)
    x[0, rng.integers(0, n)] = 0.0
    x[2, n - 1] = 0.0
    x[1] = (rng.standard_normal(n) * 8.0).astype(np.float32)
    x[1, rng.integers(0, n, 40)] = -np.inf
    x[1, :: 97] = 1e-40  # subnormal: flushed
    got = logsumexp_rows_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), _chain_order(x).view(np.int32))


def test_non_finite_rows():
    x = torch.randn(5, 300)
    x[0] = float("-inf")
    x[1, 7] = float("inf")
    x[2, 9] = float("nan")
    x[3, :50] = 1e-40  # subnormals are flushed
    x[4] = -1e30
    got, want = logsumexp_rows_ref(x), torch.logsumexp(x, dim=-1)
    assert got[0] == float("-inf") and got[1] == float("inf") and torch.isnan(got[2])
    torch.testing.assert_close(got[3:], want[3:], rtol=LSE_RTOL, atol=0)


def test_wrapper_and_ops_on_the_cpu():
    rk.reset_launch_counts()
    x = torch.randn(2, 3, 700)
    got = logsumexp(x)
    assert got.shape == (2, 3) and logsumexp(x, keepdim=True).shape == (2, 3, 1)
    assert torch.equal(_bits(got.reshape(-1)), _bits(logsumexp_rows_ref(x.reshape(6, 700))))
    assert torch.equal(_bits(logsumexp(x[1, 2])), _bits(got[1, 2]))
    assert rk.logsumexp_rows.launches == 0
    with pytest.raises(ValueError, match="float32"):
        rk.logsumexp_rows(x.double()[0])
    with pytest.raises(ValueError, match="float32"):
        rk.logsumexp_rows(x)
