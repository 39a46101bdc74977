"""A threefry2x32 twin of ``jax.random`` as the Megopolis path uses it.

The resampler contract consumes JAX keys: the offsets and the hash seed of
one Megopolis call are derived from the key with ``split``, ``randint`` and
``key_to_seed``, and the particle filter threads a key chain through
``split``.  So that the port consumes a key exactly as the reference does,
this module re-implements the threefry2x32 PRNG in the partitionable mode
(``jax_threefry_partitionable=True``, jax 0.9.0's default):

* ``split``, ``fold_in``, ``randint`` and ``uniform`` match ``jax.random``
  bit for bit;
* ``normal`` follows JAX's transform (a uniform on (-1, 1), then
  ``sqrt(2)·erfinv``) with XLA's single-precision ``erf_inv`` polynomial
  (Giles), written out here; it matches ``jax.random.normal`` to within
  3 ULP on the CPU against jax 0.9.0 (``tests/test_torch_random.py``
  holds the bound over 5·10^5 draws); the differences come from
  ``log1p``'s rounding;
* ``gumbel`` and ``categorical`` follow ``jax.random.gumbel`` (mode
  "low") and ``jax.random.categorical``: the uniforms bit for bit, the two
  ``log``s torch's, so a draw is JAX's where the logs round alike and an
  ``argmax`` where no near tie flips (``tests/test_torch_smc.py`` states
  both shares);
* ``gamma`` follows jax 0.9.0's ``_gamma_impl`` (Marsaglia-Tsang, one key
  per element and its own rejection loop); it calls ``normal``, ``log``
  and ``pow``, so a lane is bit for bit with ``jax.random.gamma`` only where
  those agree (``tests/test_torch_gamma.py`` states the share and the ULP
  bound of the rest).

A key is an ``int64`` tensor ``[..., 2]`` holding the two uint32 words of
JAX's raw key data.  All integer arithmetic runs in ``int64`` masked with
``& 0xFFFFFFFF``: torch's ``uint32`` lacks ``+``, ``>>``, ``%`` and ``<=``
on the CPU.  The same code runs on Python ints, CPU tensors and CUDA
tensors; key chains live on the CPU, and bulk draws (``normal`` over N
particles) run on the device of the ``device`` argument.

``split``, ``fold_in`` and ``random_bits`` are the points that consume a
key (``randint``, ``uniform`` and ``normal`` go through them), and so is
``kernels.common.key_to_seed``, which turns a key into the seed of the
kernels' hash RNG; while an observer is installed (``observe_keys``) each
reports its key to it (``report_key``), for the contract checks' RNG
pass.
"""

from __future__ import annotations

import contextlib
import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
#: Observers of key consumption: callables ``(kind, key, data)``.
_KEY_OBSERVERS: list = []


@contextlib.contextmanager
def observe_keys(observer):
    """Report every key consumed inside the block to ``observer(kind, key,
    data)``: ``kind`` is ``"split"``, ``"fold_in"`` (``data`` its int),
    ``"random_bits"`` or ``"seed"`` (``key_to_seed``), ``key`` the key or
    key bank consumed."""
    _KEY_OBSERVERS.append(observer)
    try:
        yield observer
    finally:
        _KEY_OBSERVERS.remove(observer)


def report_key(kind: str, key, data=None):
    """Report one consumed key to the observers of ``observe_keys``."""
    for observer in tuple(_KEY_OBSERVERS):
        observer(kind, key, data)


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), as ``jax._src.prng``'s
    ``_threefry2x32_lowering``.  Arguments are uint32 values held in Python
    ints or ``int64`` tensors (broadcast together); returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + k1) & MASK32
    x2 = (x2 + k2) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**63``: the key words
    are the seed's high and low 32 bits."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"PRNGKey: seed must be non-negative; got {seed}")
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The raw uint32 words of a key, ``int64[..., 2]`` (keys are raw data
    here, so this is the key itself)."""
    return key


def _words(key: torch.Tensor, ndim: int):
    """Key words ``[..., 1 x ndim]`` ready to broadcast against counters of
    ``ndim`` dimensions."""
    k1 = key[..., 0].reshape(key.shape[:-1] + (1,) * ndim)
    k2 = key[..., 1].reshape(key.shape[:-1] + (1,) * ndim)
    return k1, k2


def _iota(shape, device) -> torch.Tensor:
    """The low words of JAX's ``iota_2x32_shape``; the high words are zero
    for every array smaller than 2**32 elements."""
    size = math.prod(shape)
    if size >= 1 << 32:
        raise NotImplementedError("random bits over 2**32 or more elements")
    return torch.arange(size, dtype=torch.int64, device=device).reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): ``[..., 2] -> [..., num, 2]``;
    a key bank splits row by row as ``jax.vmap(jax.random.split)``."""
    if _KEY_OBSERVERS:
        report_key("split", key)
    k1, k2 = _words(key, 1)
    b1, b2 = threefry2x32(k1, k2, 0, _iota((num,), key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    if _KEY_OBSERVERS:
        report_key("fold_in", key, int(data) & MASK32)
    k1, k2 = key[..., 0], key[..., 1]
    b1, b2 = threefry2x32(k1, k2, 0, int(data) & MASK32)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element (``_threefry_random_bits_partitionable``):
    ``int64[..., *shape]`` in ``[0, 2**32)``.  The counters are made on
    ``device`` (default: the key's)."""
    if _KEY_OBSERVERS:
        report_key("random_bits", key)
    shape = tuple(shape)
    device = key.device if device is None else torch.device(device)
    k1, k2 = _words(key.to(device), len(shape))
    b1, b2 = threefry2x32(k1, k2, 0, _iota(shape, device))
    return b1 ^ b2


#: Most counters one chunk of ``categorical``'s draw makes at a time: its
#: ``int64`` temporaries stay near 2**25 elements (256 MiB each).
CATEGORICAL_CHUNK = 1 << 25


def _bits_rows(key: torch.Tensor, rows: int, width: int, row0: int, device) -> torch.Tensor:
    """Rows ``row0 .. row0 + rows`` of ``random_bits(key, (R, width))``,
    ``int64[rows, width]``: their counters are ``row·width + col``, so any
    split into row chunks gives the whole draw's bits (the key is not
    reported: the caller consumes it once)."""
    if (row0 + rows) * width >= 1 << 32:
        raise NotImplementedError("random bits over 2**32 or more elements")
    ctr = torch.arange(row0 * width, (row0 + rows) * width, dtype=torch.int64,
                       device=device).reshape(rows, width)
    k1, k2 = key.to(device)[0], key.to(device)[1]
    b1, b2 = threefry2x32(k1, k2, 0, ctr)
    return b1 ^ b2


def _gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") from the uniform's bits:
    ``-log(-log(u))``, ``u`` uniform on ``[tiny, 1)`` as ``uniform`` makes it."""
    tiny = torch.finfo(torch.float32).tiny
    floats = _bits_to_unit(bits)
    lo = torch.tensor(tiny, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=floats.device)
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    return -torch.log(-torch.log(u))


def gumbel(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default mode
    ("low"): ``-log(-log(uniform(key, shape, minval=tiny, maxval=1)))``.  The
    uniforms are ``jax.random.uniform``'s bit for bit; ``log`` is torch's,
    not XLA-CPU's, so a draw is JAX's only where the two logs round alike
    (ROADMAP Queue C item 9; ``tests/test_torch_smc.py`` states the share)."""
    return _gumbel_of_bits(random_bits(key, shape, device))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` over the rows of
    ``logits [R, V]`` (float32): ``argmax(gumbel(key, (R, V)) + logits)``, the
    first index of the largest on ties, ``int64[R]`` on the logits' device.
    The draw runs in row chunks of at most ``CATEGORICAL_CHUNK`` counters,
    each chunk's bits those of the whole draw, so the result does not
    depend on the chunking; the key is consumed once."""
    if logits.ndim != 2:
        raise ValueError(f"categorical: logits must be [R, V]; got {list(logits.shape)}")
    if _KEY_OBSERVERS:
        report_key("random_bits", key)
    rows, width = logits.shape
    step = max(1, CATEGORICAL_CHUNK // width)
    out = []
    for r0 in range(0, rows, step):
        r = min(step, rows - r0)
        g = _gumbel_of_bits(_bits_rows(key, r, width, r0, logits.device))
        out.append(torch.argmax(g + logits[r0:r0 + r], dim=-1))
    return torch.cat(out) if len(out) > 1 else out[0]


def randint(key: torch.Tensor, shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``:
    two 32-bit draws per value folded modulo the span, in JAX's wrapped
    uint32 arithmetic.  Returns ``int32[..., *shape]``; the key is split
    where it lies and the draws are made on ``device`` (default: the
    key's)."""
    if not -(1 << 31) <= minval < maxval <= (1 << 31) - 1:
        raise ValueError(f"randint: need int32 bounds minval < maxval; got {minval}, {maxval}")
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape, device)
    lo = random_bits(keys[..., 1, :], shape, device)
    span = maxval - minval
    mult = (((1 << 16) % span) ** 2 & MASK32) % span  # JAX squares in uint32
    off = ((((hi % span) * mult) & MASK32) + lo % span) & MASK32
    return (minval + off % span).to(torch.int32)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float trick: 23 random mantissa bits under exponent 0, minus 1:
    a float32 in [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _uniform_of_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    floats = _bits_to_unit(bits)
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _uniform_of_bits(random_bits(key, shape, device), minval, maxval)


def bernoulli(key: torch.Tensor, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform(key, shape) < float32(p)``, a bool tensor."""
    u = uniform(key, shape, device=device)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


# XLA's single-precision erf_inv (Giles, "Approximating the erfinv function"):
# degree-9 polynomials in w = -log1p(-x^2), split at w = 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erfinv`` by XLA's polynomial, so that ``normal`` lands
    within a few ULP of ``jax.random.normal`` (``torch.erfinv`` is the
    exact function, which XLA's approximation departs from in the tails)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge).to(torch.float32) + p * w
    big = torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1.0, x * big, p * x)


#: Most elements one chunk of a single key's ``normal`` draw makes at a
#: time: its ``int64`` temporaries stay near 2**27 elements (1 GiB each).
NORMAL_CHUNK = 1 << 27


def _normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    return erfinv_xla(_uniform_of_bits(bits, lo, 1.0)) * math.sqrt(2.0)


def normal(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` to within 3 ULP.  A key
    bank ``[S, 2]`` draws ``[S, *shape]``, row ``s`` from ``key[s]``.  One
    key's draw of more than ``NORMAL_CHUNK`` elements runs in chunks of the
    flat counters, each chunk's values those of the whole draw (an expert
    weight of 10^9 elements would otherwise need tens of GB of
    temporaries)."""
    size = math.prod(shape)
    if key.ndim > 1 or size <= NORMAL_CHUNK:
        return _normal_of_bits(random_bits(key, shape, device))
    if _KEY_OBSERVERS:
        report_key("random_bits", key)
    device = key.device if device is None else torch.device(device)
    out = torch.empty(size, dtype=torch.float32, device=device)
    for c0 in range(0, size, NORMAL_CHUNK):
        rows = min(NORMAL_CHUNK, size - c0)
        out[c0:c0 + rows] = _normal_of_bits(_bits_rows(key, rows, 1, c0, device)[:, 0])
    return out.reshape(tuple(shape))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _gamma_lanes(keys: torch.Tensor, alpha: float, device) -> torch.Tensor:
    """``_gamma_one`` of jax 0.9.0 for one scalar ``alpha`` over a bank of
    lane keys ``[M, 2]``, as its batched while loops run it: each lane
    keeps its own key chain and draws again only while its own condition
    holds.  Returns ``f32[M]`` on ``device``."""
    m = keys.shape[0]
    a_orig = torch.full((m,), alpha, dtype=torch.float32, device=device)
    one, zero = _f32(1.0, a_orig), _f32(0.0, a_orig)
    boost_mask = a_orig >= one
    a = torch.where(boost_mask, a_orig, a_orig + one)
    d = a - _f32(1.0 / 3.0, a)
    c = _f32(1.0 / 3.0, a) / torch.sqrt(d)
    halves = split(keys)
    key, subkey = halves[:, 0], halves[:, 1]  # the lanes' key chains, on the CPU
    x_sq = torch.zeros(m, dtype=torch.float32, device=device)
    v_cube = torch.ones(m, dtype=torch.float32, device=device)
    u = torch.full((m,), 2.0, dtype=torch.float32, device=device)
    while True:
        # _cond_fn, with X = x²: draw again while U >= 1 - 0.0331·X² and
        # log U >= X/2 + d·(1 - V + log V) (the squeeze and the full test).
        squeeze = u >= one - _f32(0.0331, u) * (x_sq * x_sq)
        full = torch.log(u) >= x_sq * _f32(0.5, u) + d * ((one - v_cube) + torch.log(v_cube))
        live = torch.nonzero(squeeze & full).squeeze(-1)
        if live.numel() == 0:
            break
        three = split(key[live.cpu()], 3)
        key[live.cpu()] = three[:, 0]
        # The inner loop: normal draws until v = 1 + x·c > 0.
        kk = three[:, 1]
        v = torch.full((live.numel(),), -1.0, dtype=torch.float32, device=device)
        x = torch.zeros_like(v)
        c_live = c[live]
        pending = torch.arange(live.numel(), device=device)
        while pending.numel():
            pair = split(kk[pending.cpu()])
            kk[pending.cpu()] = pair[:, 0]
            xp = normal(pair[:, 1], (), device=device)
            x[pending], v[pending] = xp, one + xp * c_live[pending]
            pending = pending[v[pending] <= zero]
        x_sq[live] = x * x
        v_cube[live] = (v * v) * v
        u[live] = uniform(three[:, 2], (), device=device)
    samples = one - uniform(subkey, (), device=device)
    boost = torch.where(boost_mask, one, torch.pow(samples, one / a_orig))
    return (d * v_cube) * boost


def gamma(key: torch.Tensor, alpha: float, shape, device=None) -> torch.Tensor:
    """``jax.random.gamma(key, alpha, shape, float32)`` for one scalar
    ``alpha > 0``: the key splits into one key per element (``split(key,
    prod(shape))``), and each element runs Marsaglia-Tsang's rejection loop
    on its own key (alpha < 1 boosted to alpha + 1, times ``(1 - u)^(1 /
    alpha)``).  Lanes match JAX bit for bit where ``normal``, ``log`` and
    ``pow`` round as XLA's do (``tests/test_torch_gamma.py``)."""
    if not alpha > 0:
        raise ValueError(f"gamma: alpha must be positive; got {alpha}")
    shape = tuple(shape)
    device = key.device if device is None else torch.device(device)
    keys = split(key, math.prod(shape))
    return _gamma_lanes(keys, float(alpha), device).reshape(shape)
