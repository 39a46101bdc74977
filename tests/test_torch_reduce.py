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
