"""A random number generator that draws by global element index.

The port of ``vescale_tpu/random.py``.  The reference relies on JAX's
threefry in its partitionable mode: the bits of element ``i`` of a draw are
a hash of ``(key, i)``, with ``i`` the element's index in the *global*
shape, so a sharded draw equals the single-device one bit for bit.  This
module is that generator in plain PyTorch integer ops:

  * ``threefry2x32``: the Threefry-2x32 hash (20 rounds) on int64 tensors
    holding 32-bit words, masked after every add and rotate (torch's
    ``uint32`` lacks shifts on some devices);
  * ``key(seed)`` and ``fold_in`` as ``jax.random.key`` / ``fold_in`` build
    them (a key is a pair of Python ints); ``fold_in_static`` and
    ``make_rng`` as flax derives a module's key from the key passed to
    ``apply`` (``flax/core/scope.py``: the SHA-1 of the module path and the
    scope's call counter folded in once);
  * ``random_bits`` over the global iota, split into its high and low
    32-bit words, as ``jax._src.prng._threefry_random_bits_partitionable``;
  * ``uniform``, ``bernoulli`` and ``normal`` as ``jax.random`` builds them.

For the same key, ``random_bits``, ``uniform``, ``bernoulli`` and
``dropout`` are bitwise JAX's, on the CPU and on the card.  ``normal`` is
``sqrt(2) * erfinv(u)`` as in JAX, but ``torch.erfinv`` is not XLA's
polynomial, so it agrees to a few float32 ulps (the bound is stated in
``tests/test_torch_random.py``).  A seed in ``[0, 2**31)`` gives JAX's key in
either of its precision modes.

Every draw takes ``global_offset``/``global_shape`` (this piece is the box
at ``global_offset`` of a ``global_shape`` tensor) or ``index`` (the
global linear index of each element, any layout): a rank draws only its
shard.  ``RNGStateTracker`` keeps the reference's management surface: a
seeded base key, named streams (``zlib.crc32`` of the name), ``next_key``,
and the three tracker aliases.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import zlib
from typing import Optional, Sequence, Tuple

import torch

from .device import resolve_device

__all__ = [
    "key",
    "as_key",
    "fold_in",
    "fold_in_static",
    "make_rng",
    "batch_rows",
    "current_batch_rows",
    "threefry2x32",
    "random_bits",
    "linear_index",
    "manual_seed",
    "get_rng_tracker",
    "RNGStateTracker",
    "OffsetBasedRNGTracker",
    "ThreadBasedRNGTracker",
    "TensorParallelRNGTracker",
    "uniform",
    "normal",
    "bernoulli",
    "dropout",
]

Key = Tuple[int, int]
_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """In place: rotate the 32-bit words in ``x`` left by ``r``."""
    hi = torch.bitwise_left_shift(x, r).bitwise_and_(_M32)
    return x.bitwise_right_shift_(32 - r).bitwise_or_(hi)


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 of the word pairs ``(x1, x2)`` under key ``(k1, k2)``
    (``jax._src.prng._threefry2x32_lowering``).  ``x1``, ``x2``: int64
    tensors of values in ``[0, 2**32)``; returns two such tensors."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x1 = (x1 + ks[0]).bitwise_and_(_M32)
    x2 = (x2 + ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x1.add_(x2).bitwise_and_(_M32)
            _rotl(x2, r).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x2.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x1, x2


def _hash_words(k: Key, w1: int, w2: int) -> Key:
    a, b = threefry2x32(k[0], k[1], torch.tensor([w1], dtype=torch.int64),
                        torch.tensor([w2], dtype=torch.int64))
    return int(a.item()), int(b.item())


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s data: the seed's high and low words."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: the hash of the word pair ``(0, data)``."""
    return _hash_words(k, 0, int(data) & _M32)


def as_key(k) -> Key:
    """A key from its two 32-bit words: a pair, a list, or an array or
    tensor of two (``jax.random.key_data`` of a JAX key, say)."""
    words = [int(w) for w in (k.tolist() if hasattr(k, "tolist") else k)]
    if len(words) != 2:
        raise ValueError(f"a key is two 32-bit words, got {words}")
    return words[0] & _M32, words[1] & _M32


def fold_in_static(k: Key, data: Sequence) -> Key:
    """flax's ``_fold_in_static``: the first 4 bytes (big-endian) of the
    SHA-1 of ``data`` (strings as UTF-8, ints as their big-endian bytes,
    no separator: ``flax_fix_rng_separator`` off, flax's default) folded
    into ``k``; ``k`` itself for empty ``data``."""
    if not data:
        return k
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected an int or a string, got {x!r}")
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))


def make_rng(k: Key, path: Sequence[str], count: int = 1) -> Key:
    """The key flax's ``make_rng`` gives the module at ``path`` (its scope
    names from the root, e.g. ``("h_0", "attn", "Dropout_0")``) on its
    ``count``-th call in one ``apply`` whose rng for the stream is ``k``."""
    return fold_in_static(k, (*path, int(count)))


_ROWS = threading.local()


@contextlib.contextmanager
def batch_rows(offset: int, total: int):
    """Declare that the batch this process computes on is rows ``[offset,
    offset + rows)`` of a global batch of ``total`` rows (a data-parallel
    rank's piece), so a draw keyed by a batch element's global index
    (dropout) takes this rank's rows of the global draw."""
    prev = getattr(_ROWS, "rows", None)
    _ROWS.rows = (int(offset), int(total))
    try:
        yield
    finally:
        _ROWS.rows = prev


def current_batch_rows() -> Optional[Tuple[int, int]]:
    """``(offset, total)`` of the innermost :func:`batch_rows`, or None."""
    return getattr(_ROWS, "rows", None)


def linear_index(index_set, global_shape: Sequence[int], device) -> torch.Tensor:
    """The global linear (row-major) index of every element of a local
    piece described by a ``spec.DArraySpec.index_set``, in its layout."""
    kind, segs = index_set
    if kind == "flat":
        (off, size), = segs
        return torch.arange(off, off + size, dtype=torch.int64, device=device)
    out = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(global_shape))):
        idx = torch.cat([torch.arange(a, a + n, dtype=torch.int64, device=device) for a, n in segs[d]])
        shape = [1] * len(global_shape)
        shape[d] = idx.numel()
        out = out + idx.view(shape) * stride
        stride *= int(global_shape[d])
    return out.expand(tuple(sum(n for _, n in s) for s in segs))


def _index(shape, device, global_offset=None, global_shape=None, index=None) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if index is not None:
        if tuple(index.shape) != shape:
            raise ValueError(f"index of shape {tuple(index.shape)} for a draw of shape {shape}")
        return index.to(device=device, dtype=torch.int64)
    gshape = tuple(global_shape) if global_shape is not None else shape
    goff = tuple(global_offset) if global_offset is not None else (0,) * len(shape)
    if not (len(gshape) == len(goff) == len(shape)):
        raise ValueError(f"global_offset {goff} / global_shape {gshape} for a draw of shape {shape}")
    for s, o, g in zip(shape, goff, gshape):
        if o < 0 or o + s > g:
            raise ValueError(f"the box {goff}+{shape} does not fit in {gshape}")
    return linear_index(("dense", [[(o, s)] for o, s in zip(goff, shape)]), gshape, device)


def random_bits(k: Key, shape, bit_width: int = 32, *, device=None, global_offset=None,
                global_shape=None, index=None) -> torch.Tensor:
    """Uniform random bits, JAX's partitionable threefry over the global
    iota: an int64 tensor of values in ``[0, 2**bit_width)`` (8, 16 or 32
    bits, as ``jax.random.bits``)."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width {bit_width}: expected 8, 16 or 32")
    dev = resolve_device(device)
    idx = _index(shape, dev, global_offset, global_shape, index)
    b1, b2 = threefry2x32(k[0], k[1], torch.bitwise_right_shift(idx, 32), idx.bitwise_and(_M32))
    bits = b1.bitwise_xor_(b2)
    return bits if bit_width == 32 else bits.bitwise_and_((1 << bit_width) - 1)


_FLOAT = {  # dtype: (bits, mantissa bits, the int dtype of its width)
    torch.float32: (32, 23, torch.int32),
    torch.float16: (16, 10, torch.int16),
    torch.bfloat16: (16, 7, torch.int16),
}


def _unit_floats(k: Key, shape, dtype, dev, goff, gshape, index) -> torch.Tensor:
    """Floats in [1, 2) from random mantissa bits, minus 1: JAX's
    ``_uniform`` before its scale and shift."""
    if dtype not in _FLOAT:
        raise TypeError(f"uniform only accepts floating dtypes {list(_FLOAT)}, got {dtype}")
    nbits, nmant, int_dtype = _FLOAT[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(k, shape, rng_bits, device=dev, global_offset=goff, global_shape=gshape,
                       index=index)
    one = torch.tensor(1.0, dtype=dtype).view(int_dtype).item()
    word = bits.bitwise_right_shift_(rng_bits - nmant).bitwise_or_(one)
    floats = word.to(int_dtype).view(dtype)
    return floats - torch.tensor(1.0, dtype=dtype, device=floats.device)


class RNGStateTracker(threading.local):
    """The seeded base key plus named sub-streams (reference
    RNGStateTracker, random.py:115)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self._seed = int(seed)
        self._base = key(self._seed)
        self._streams = {}
        self._counters = {}

    @property
    def base_key(self) -> Key:
        return self._base

    def stream(self, name: str = "default") -> Key:
        """A named, stateless stream key; a stable digest (not ``hash``),
        so every process and run derives the same one."""
        if name not in self._streams:
            digest = zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF
            self._streams[name] = fold_in(self._base, digest)
        return self._streams[name]

    def next_key(self, name: str = "default") -> Key:
        """Successive keys of a stream: a pure function of (seed, name, call
        index), so ranks that call in the same order agree."""
        c = self._counters.get(name, 0)
        self._counters[name] = c + 1
        return fold_in(self.stream(name), c)

    @contextlib.contextmanager
    def _distribute_region(self, spec=None, name: str = "default"):
        """Parity with the reference's region around random ops: the draw
        is by global index, so the region only scopes a key."""
        yield self.next_key(name)

    # ----------------------------------------------------------- sampling
    def uniform(self, shape, dtype=torch.float32, *, key=None, minval=0.0, maxval=1.0,
                name: str = "default", device=None, global_offset=None, global_shape=None,
                index=None) -> torch.Tensor:
        """``jax.random.uniform``: ``max(minval, u * (maxval - minval) +
        minval)`` with ``u`` in [0, 1), in ``dtype``, rounded where XLA
        rounds it."""
        k = key if key is not None else self.next_key(name)
        dev = resolve_device(device)
        u = _unit_floats(k, shape, dtype, dev, global_offset, global_shape, index)
        lo = torch.tensor(minval, dtype=dtype, device=dev)
        hi = torch.tensor(maxval, dtype=dtype, device=dev)
        if minval == 0.0 and maxval == 1.0:
            return u
        if dtype == torch.bfloat16:  # XLA rounds each bfloat16 op
            return torch.maximum(lo, u * (hi - lo) + lo)
        # XLA fuses the float32/float16 scale and shift into one rounding;
        # in float64 the product and the sum are exact for these mantissas
        # unless the range's ends lie many binades apart
        scaled = u.double() * (hi - lo).double() + lo.double()
        return torch.maximum(lo, scaled.to(dtype))

    def normal(self, shape, dtype=torch.float32, *, key=None, name: str = "default", device=None,
               global_offset=None, global_shape=None, index=None) -> torch.Tensor:
        """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform
        in (-1, 1) (``torch.erfinv``: a few ulps from XLA's)."""
        k = key if key is not None else self.next_key(name)
        lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype)).item()
        u = self.uniform(shape, dtype, key=k, minval=lo, maxval=1.0, device=device,
                         global_offset=global_offset, global_shape=global_shape, index=index)
        return torch.erfinv(u) * torch.tensor(2.0 ** 0.5, dtype=dtype, device=u.device)

    def bernoulli(self, p: float, shape, *, key=None, name: str = "default", device=None,
                  global_offset=None, global_shape=None, index=None) -> torch.Tensor:
        """``jax.random.bernoulli`` with a float ``p``: ``uniform < p`` in
        float32."""
        k = key if key is not None else self.next_key(name)
        u = self.uniform(shape, torch.float32, key=k, device=device, global_offset=global_offset,
                         global_shape=global_shape, index=index)
        return u < torch.tensor(p, dtype=torch.float32, device=u.device)

    def dropout(self, x: torch.Tensor, rate: float, *, key=None, name: str = "default",
                global_offset=None, global_shape=None, index=None) -> torch.Tensor:
        """The reference's global-semantics dropout: the mask is a function
        of each element's global position, so a shard drops exactly what
        the whole tensor would.  ``x``'s device is where it runs."""
        if rate == 0.0:
            return x
        keep = self.bernoulli(1.0 - rate, x.shape, key=key, name=name, device=x.device,
                              global_offset=global_offset, global_shape=global_shape, index=index)
        scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / scale, torch.zeros_like(x))


# The reference's three trackers are one implementation; the aliases keep
# the migration surface.
class OffsetBasedRNGTracker(RNGStateTracker):
    pass


class ThreadBasedRNGTracker(RNGStateTracker):
    pass


class TensorParallelRNGTracker(RNGStateTracker):
    pass


_TRACKER: Optional[RNGStateTracker] = None


def get_rng_tracker() -> RNGStateTracker:
    global _TRACKER
    if _TRACKER is None:
        _TRACKER = RNGStateTracker(0)
    return _TRACKER


def manual_seed(seed: int, device_mesh=None) -> None:
    """Seed the process's tracker (reference random.py:62); every rank
    seeds alike, so they derive the same keys."""
    get_rng_tracker().seed(seed)


def uniform(shape, dtype=torch.float32, **kw) -> torch.Tensor:
    return get_rng_tracker().uniform(shape, dtype, **kw)


def normal(shape, dtype=torch.float32, **kw) -> torch.Tensor:
    return get_rng_tracker().normal(shape, dtype, **kw)


def bernoulli(p: float, shape, **kw) -> torch.Tensor:
    return get_rng_tracker().bernoulli(p, shape, **kw)


def dropout(x: torch.Tensor, rate: float, **kw) -> torch.Tensor:
    return get_rng_tracker().dropout(x, rate, **kw)
