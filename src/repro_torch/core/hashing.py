"""Pairwise-independent hashing over the Mersenne prime 2**31 - 1.

Port of ``src/repro/core/hashing.py``.  The family is the paper's
``h(x) = ((a*x + b) mod p) mod w`` (Section 6.2).  The reference computes
the 62-bit product ``a*x`` in 16-bit limbs of uint32 because JAX runs
without x64; PyTorch has int64 on every device (and no uint32 ``>>``, ``+``,
``%`` or ``<``), so the port computes in int64, where ``a*x < 2**62`` is
exact.  Node keys are uint32 VALUES carried in int64 tensors: convert a
numpy uint32 array with :func:`keys_to_tensor` (``astype(np.int64)`` before
``torch.from_numpy``).

:class:`HashFamily` keeps a host (numpy) copy of its coefficients beside
the device tensors, so value comparisons (the closure cache key,
``same_family``) never wait on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

MERSENNE_P = (1 << 31) - 1  # 2**31 - 1, prime
_MASK32 = 0xFFFFFFFF


def keys_to_tensor(keys, device: Optional[torch.device] = None) -> torch.Tensor:
    """uint32 node keys (numpy or sequence) -> int64 tensor on ``device``.
    The copy to a card does not wait for work already queued there (a
    pageable source is staged before the call returns)."""
    arr = np.ascontiguousarray(np.asarray(keys, np.uint32).astype(np.int64))
    return torch.from_numpy(arr).to(device, non_blocking=True)


def mulmod31(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(a * x) mod (2**31 - 1) for int64 a, x in [0, 2**31)."""
    return (a * x) % MERSENNE_P


def affine_hash(keys: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: int) -> torch.Tensor:
    """h(x) = (((a*x + b) mod p) mod w) as int64 in [0, w).

    ``keys`` hold uint32 values (int64 tensor); they are reduced mod p
    first.  ``a`` and ``b`` broadcast against ``keys``."""
    k = keys % MERSENNE_P
    h = (mulmod31(a, k) + b) % MERSENNE_P
    return h % w


def sign_hash(keys: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CountSketch sign hash: ±1 (int64), from the low bit of the affine hash."""
    k = keys % MERSENNE_P
    h = (mulmod31(a, k) + b) % MERSENNE_P
    return 1 - 2 * (h & 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x < 2**32, in int64 without overflow: split the
    constant into 16-bit halves so every partial product stays below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def mix_keys(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mix two uint32 keys into one (the reference's Knuth-constant mix),
    bit-identical to the uint32 arithmetic of ``repro.core.hashing``."""
    h = _mul32(x & _MASK32, 0x9E3779B1)
    h = _mul32(h ^ (y & _MASK32), 0x85EBCA6B)
    return h ^ (h >> 13)


# ---------------------------------------------------------------------------
# Hash family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class HashFamily:
    """d independent affine hashes onto [0, w).

    ``a``/``b`` are (d,) int64 device tensors; ``a_host``/``b_host`` are the
    same coefficients as (d,) uint32 numpy arrays."""

    a: torch.Tensor
    b: torch.Tensor
    w: int
    a_host: np.ndarray
    b_host: np.ndarray

    @staticmethod
    def from_host(a, b, w: int, device: Optional[torch.device] = None) -> "HashFamily":
        """Build from host coefficient arrays (any integer dtype, values < p)."""
        a_host = np.asarray(a).astype(np.uint32).reshape(-1)
        b_host = np.asarray(b).astype(np.uint32).reshape(-1)
        return HashFamily(
            keys_to_tensor(a_host, device),
            keys_to_tensor(b_host, device),
            int(w),
            a_host,
            b_host,
        )

    def to(self, device: Optional[torch.device]) -> "HashFamily":
        return HashFamily.from_host(self.a_host, self.b_host, self.w, device)

    @property
    def depth(self) -> int:
        return int(self.a_host.shape[0])

    @property
    def device(self) -> torch.device:
        return self.a.device

    def __call__(self, keys: torch.Tensor) -> torch.Tensor:
        """keys (...,) uint32 values in int64 -> (d, ...) int64 buckets."""
        shape = (self.depth,) + (1,) * keys.ndim
        return affine_hash(keys[None], self.a.view(shape), self.b.view(shape), self.w)

    def signs(self, keys: torch.Tensor) -> torch.Tensor:
        """keys (...,) -> (d, ...) ±1 signs (uses an independent slice of b)."""
        shape = (self.depth,) + (1,) * keys.ndim
        a2 = self.b.view(shape) | 1
        b2 = self.a.view(shape)
        return sign_hash(keys[None], a2, b2)

    def same_values(self, other: "HashFamily") -> bool:
        return (
            self.w == other.w
            and np.array_equal(self.a_host, other.a_host)
            and np.array_equal(self.b_host, other.b_host)
        )


def make_hash_family(
    generator: torch.Generator,
    depth: int,
    width: int,
    device: Optional[torch.device] = None,
) -> HashFamily:
    """Sample a HashFamily: a ~ U[1, p-1], b ~ U[0, p-1], drawn from the
    explicit CPU ``generator`` (its stream is PyTorch's, not ``jax.random``'s:
    parity tests build both sides from the same arrays instead)."""
    a = torch.randint(1, MERSENNE_P, (depth,), generator=generator, dtype=torch.int64)
    b = torch.randint(0, MERSENNE_P, (depth,), generator=generator, dtype=torch.int64)
    return HashFamily.from_host(a.numpy(), b.numpy(), width, device)


# ---------------------------------------------------------------------------
# Host-side (numpy, exact uint64) reference used by the data pipeline
# ---------------------------------------------------------------------------


def affine_hash_np(keys: np.ndarray, a: np.ndarray, b: np.ndarray, w: int) -> np.ndarray:
    """Exact uint64 reference of affine_hash (host path + test oracle)."""
    k = keys.astype(np.uint64) % np.uint64(MERSENNE_P)
    h = (a.astype(np.uint64) * k + b.astype(np.uint64)) % np.uint64(MERSENNE_P)
    return (h % np.uint64(w)).astype(np.int32)


def fnv1a_label(label: Any) -> int:
    """Stable 32-bit FNV-1a of an arbitrary node label (host side).

    Graph streams carry IPs / user-IDs / strings; this maps them to the
    uint32 key space the device hashes expect."""
    if isinstance(label, (int, np.integer)):
        return int(label) & 0xFFFFFFFF
    data = str(label).encode("utf-8")
    h = 0x811C9DC5
    for byte in data:
        h ^= byte
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def fnv1a_labels(labels) -> np.ndarray:
    """Vectorized :func:`fnv1a_label`: a batch of node labels -> uint32 keys.

    Element-for-element identical to ``fnv1a_label``: integer labels are one
    masked cast; string labels loop over BYTE COLUMNS of the utf-8 matrix
    (max-label-length iterations, each an O(n) numpy op).  Labels holding
    NUL bytes, mixed int/str lists and other objects take the per-element
    path.  Returns an array of ``labels``' shape (0-d for a scalar)."""
    if isinstance(labels, (list, tuple)) and not (
        all(isinstance(x, str) for x in labels)
        or all(isinstance(x, (int, np.integer)) for x in labels)
    ):
        # Mixed int/str labels: np.asarray would silently stringify the ints
        # ("1" hashes differently from 1) — force the per-element path.
        labels = np.asarray(labels, dtype=object)
    arr = np.asarray(labels)
    if arr.dtype == np.uint32:
        return arr
    if arr.dtype.kind in "ib":  # bools are ints to fnv1a_label (True -> 1)
        return (arr.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    if arr.dtype.kind == "u":
        return (arr.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if arr.dtype.kind == "U" and "\x00" not in "".join(arr.ravel().tolist()):
        flat = arr.ravel()
        enc = np.char.encode(flat, "utf-8")  # S<width>, NUL-padded
        width = enc.dtype.itemsize
        h = np.full(flat.shape, 0x811C9DC5, np.uint32)
        if width and flat.size:
            mat = np.ascontiguousarray(enc).view(np.uint8).reshape(flat.size, width)
            lengths = np.char.str_len(enc)  # utf-8 byte length per label
            prime = np.uint32(0x01000193)
            with np.errstate(over="ignore"):  # uint32 wraparound is the hash
                for j in range(width):
                    live = j < lengths
                    h = np.where(live, (h ^ mat[:, j].astype(np.uint32)) * prime, h)
        return h.reshape(arr.shape)
    out = np.fromiter((fnv1a_label(x) for x in arr.ravel()), np.uint32, count=arr.size)
    return out.reshape(arr.shape)
