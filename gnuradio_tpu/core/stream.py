"""Stream/port typing — the compiled analog of gr::io_signature.

Reference parity: gnuradio-runtime/include/gnuradio/io_signature.h:23
(`io_signature::make(min, max, sizeof_item)`). The reference types ports by raw
item *size* in bytes; here ports carry a real dtype + vector length so the graph
compiler can do static shape algebra at trace time instead of byte arithmetic at
runtime.

GNU Radio type-suffix convention (SURVEY.md App. B): b=int8, s=int16, i=int32,
f=float32, c=complex64; `v` prefix = vector items. We keep that naming in block
factory functions for familiarity, mapped onto these dtypes.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

# Canonical stream dtypes (f32/c64 for SNR parity with the reference —
# SURVEY.md App. C: "Use f32, not bf16, for parity").
B = jnp.int8
S = jnp.int16
I = jnp.int32
F = jnp.float32
C = jnp.complex64

_SUFFIX = {"b": B, "s": S, "i": I, "f": F, "c": C}


def dtype_of(code: str):
    """Map a GR type-suffix character to a dtype."""
    return _SUFFIX[code]


@dataclasses.dataclass(frozen=True)
class PortSpec:
    """One stream port: item dtype + vector length.

    vlen > 1 is the analog of GR's `v`-typed ports (e.g. fft_vcc operates on
    length-N complex vectors); on device a vlen-N stream of M items is just an
    (M, N) array.
    """

    dtype: object = C
    vlen: int = 1

    def item_shape(self, n: int) -> tuple:
        return (n,) if self.vlen == 1 else (n, self.vlen)

    def zeros(self, n: int):
        return jnp.zeros(self.item_shape(n), dtype=self.dtype)

    def np_zeros(self, n: int):
        return np.zeros(self.item_shape(n), dtype=np.dtype(self.dtype))

    @property
    def is_complex(self) -> bool:
        return np.issubdtype(np.dtype(self.dtype), np.complexfloating)

    def __repr__(self):
        d = np.dtype(self.dtype).name
        return f"Port({d}x{self.vlen})" if self.vlen != 1 else f"Port({d})"


# ---------------------------------------------------------------------------
# Host <-> device boundary encoding.
#
# Rationale: production IQ capture formats are interleaved real (gr_complex
# on disk IS interleaved float32 — gr-blocks file_source semantics). So every
# host boundary crossing moves real float32 planes; complex is
# (re)constructed on device with lax.complex, which XLA folds into the
# consuming kernel.
# ---------------------------------------------------------------------------

def host_encode(arr: np.ndarray) -> np.ndarray:
    """numpy complex64 (...,) -> float32 (..., 2) view (zero-copy when
    contiguous); real arrays pass through."""
    arr = np.ascontiguousarray(arr)
    if np.issubdtype(arr.dtype, np.complexfloating):
        f = arr.astype(np.complex64, copy=False).view(np.float32)
        return f.reshape(arr.shape + (2,))
    return arr


def host_decode(arr: np.ndarray, spec: PortSpec) -> np.ndarray:
    """float32 (..., 2) -> numpy complex64 (...); real passes through."""
    if spec.is_complex:
        f = np.ascontiguousarray(arr, dtype=np.float32)
        return f.view(np.complex64).reshape(arr.shape[:-1])
    return arr


def dev_decode(arr, spec: PortSpec):
    """Device-side: float (..., 2) -> complex (...)."""
    import jax
    if spec.is_complex:
        return jax.lax.complex(arr[..., 0], arr[..., 1])
    return arr


def dev_encode(arr):
    """Device-side: complex (...) -> float32 (..., 2); real passes through."""
    if jnp.iscomplexobj(arr):
        return jnp.stack([jnp.real(arr), jnp.imag(arr)], axis=-1)
    return arr


def port(code: str = "c", vlen: int = 1) -> PortSpec:
    return PortSpec(dtype_of(code), vlen)
