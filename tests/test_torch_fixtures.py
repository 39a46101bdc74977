"""The fixture copy's index arithmetic (``kernels/fixtures/csrc/fixtures.cu``,
``copy_kernel``), written out in numpy: which elements each thread of the
launch copies, on the grid ``fixture_copy`` sizes (``analysis/smem.py``'s
``resident`` rule).  The kernel itself is held to its plain version on the
card (``tests/test_torch_cuda.py``); this documents the arithmetic and
checks that the head, the vectors and the tail cover every element once.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import smem
from repro_torch.kernels.fixtures import fixtures as fk

NT = smem.NT
#: ``COPY_UNROLL`` in ``fixtures.cu``.
COPY_UNROLL = int(re.search(
    r"#define COPY_UNROLL (\d+)",
    (Path(fk.__file__).parent / "csrc" / "fixtures.cu").read_text()).group(1))


#: ``IOTA_UNROLL`` in ``fixtures.cu``.
IOTA_UNROLL = int(re.search(
    r"#define IOTA_UNROLL (\d+)",
    (Path(fk.__file__).parent / "csrc" / "fixtures.cu").read_text()).group(1))


def _partition(offset: int, n: int):
    """What ``copy_kernel``'s threads copy of ``n`` elements of a view
    ``offset`` elements past a 16-byte boundary (``o`` at the same offset,
    as ``copy_launch`` allocates it): ``(head, first tail element, the
    vector indices each pass writes, the head elements, the tail
    elements)``."""
    blocks = smem.price("copy_kernel", 1, n).blocks
    tid = np.arange(blocks * NT, dtype=np.int64)
    stride = blocks * NT
    head = min(n, (4 - offset) % 4)
    nvec = (n - head) // 4
    tail = head + 4 * nvec
    vectors = []
    if nvec <= stride:  # at most one vector a thread
        vectors.append(tid[tid < nvec])
    else:
        for j0 in range(0, nvec, COPY_UNROLL * stride):
            for k in range(COPY_UNROLL):
                j = j0 + tid + k * stride
                vectors.append(j[j < nvec])
    return head, tail, vectors, tid[tid < head], tail + tid[tid < n - tail]


def _copied(offset: int, n: int) -> np.ndarray:
    """How many times ``copy_kernel`` writes each element."""
    head, _, vectors, heads, tails = _partition(offset, n)
    vec = np.concatenate(vectors)
    written = [head + 4 * vec + c for c in range(4)] + [heads, tails]
    return np.bincount(np.concatenate(written), minlength=n)


@pytest.mark.parametrize("n", (1, 3, 4, 5, 2047, 2048, 3000))
@pytest.mark.parametrize("offset", (0, 1, 2, 3))
def test_copy_partition_covers_each_element_once(offset, n):
    copied = _copied(offset, n)
    assert copied.shape == (n,) and (copied == 1).all()


@pytest.mark.parametrize("offset", (0, 1, 2, 3))
def test_copy_partition_at_the_unrolled_sizes(offset):
    """Past one vector a thread (2^23 + 3 on 1056 blocks: two unrolled
    passes, the last one partial): every vector once, and head, vectors and
    tail side by side."""
    n = (1 << 23) + 3
    assert smem.price("copy_kernel", 1, n).blocks == 8 * 132
    head, tail, vectors, heads, tails = _partition(offset, n)
    assert len(vectors) == 2 * COPY_UNROLL
    vec = np.sort(np.concatenate(vectors))
    assert np.array_equal(vec, np.arange((tail - head) // 4))
    assert np.array_equal(heads, np.arange(head)) and np.array_equal(tails, np.arange(tail, n))
    assert head == (4 - offset) % 4 and n - tail < 4


@pytest.mark.parametrize("offset", (0, 1, 2, 3))
def test_same_phase_empty(offset):
    """``copy_launch``'s output starts at its input's offset modulo 16
    bytes, so head and tail are the same elements in both."""
    base = torch.arange(40, dtype=torch.float32)
    x = base[offset:offset + 33]
    out = fk.same_phase_empty(x)
    assert out.shape == x.shape and out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16
    assert out.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("offset", (0, 1, 3))
def test_copy_launch_of_a_view_on_the_cpu(offset):
    """On a CPU tensor ``copy_launch`` is its plain version, views included,
    and counts no launch."""
    fk.reset_launch_counts()
    base = torch.randn(3003, generator=torch.Generator().manual_seed(offset))
    x = base[offset:offset + 3000]
    got = fk.copy_launch(x)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    assert fk.copy_launch.launches == 0


def _iota_written(offset: int, n: int) -> np.ndarray:
    """``iota_kernel`` transcribed: what its threads write into each element
    of an output view ``offset`` elements past a 16-byte boundary (-1 where
    nothing is written, -2 where an element is written twice)."""
    blocks = smem.price("iota_kernel", 1, n).blocks
    stride = blocks * NT
    tid = np.arange(stride, dtype=np.int64)
    head = min(n, (4 - offset) % 4)
    nvec = (n - head) // 4
    tail = head + 4 * nvec
    out = np.full(n, -1, dtype=np.int64)

    def write(idx, val):
        out[idx] = np.where(out[idx] == -1, val, -2)

    for j0 in range(0, nvec, IOTA_UNROLL * stride):
        for k in range(IOTA_UNROLL):
            v = j0 + tid + k * stride
            v = v[v < nvec]
            for c in range(4):
                write(head + 4 * v + c, head + 4 * v + c)
    heads, tails = tid[tid < head], tail + tid[tid < n - tail]
    write(heads, heads)
    write(tails, tails)
    return out


@pytest.mark.parametrize("n", (1, 3, 5, 2048, 3000, (1 << 23) + 3))
@pytest.mark.parametrize("offset", (0, 1, 2, 3))
def test_iota_partition_writes_each_element_its_index(offset, n):
    """Row 31's 16-byte stores, head and tail: every element of any view
    written once, with its index (2^23 + 3: past one vector a thread, on
    the co-resident grid)."""
    assert np.array_equal(_iota_written(offset, n), np.arange(n))
