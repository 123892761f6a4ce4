"""Packed-token corpus: memory-mapped, zero-copy row gathers.

The input-pipeline analog of the reference's zero-copy I/O data plane:
blkfront moves disk blocks into guest memory through granted pages
without copies through the control plane
(``xen-4.2.1/xen/common/grant_table.c``, ``drivers/block/xen-blkfront``).
Here the corpus is one flat file of token ids (the standard packed
pre-tokenized format), memory-mapped read-only and gathered into batch
staging buffers by the native runtime (``pbst_gather_rows``) — one
memcpy per sequence, no per-token Python.

The port of ``pbs_tpu.data.tokens``: the same file format, the same
windows and the same checks. Without the native runtime the numpy
gather serves, byte for byte the same rows.

File format: little-endian header ``PBST`` magic, u32 version, u32
dtype code (2=uint16, 4=uint32), u64 token count — then the tokens.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"PBST"
_HDR = struct.Struct("<4sIIQ")
_DTYPES = {2: np.uint16, 4: np.uint32}


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Pack a 1-D int token array (vocab decides u16 vs u32)."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError("tokens must be 1-D")
    if tokens.size and int(tokens.min()) < 0:
        raise ValueError("negative token ids (unsigned storage would "
                         "silently wrap them)")
    code = 2 if tokens.max(initial=0) < (1 << 16) else 4
    arr = tokens.astype(_DTYPES[code])
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HDR.pack(MAGIC, 1, code, arr.size))
        f.write(arr.tobytes())
    os.replace(tmp, path)


class TokenDataset:
    """Read side: mmap + sequence windows.

    ``sample(batch, seq_len, rng)`` draws random windows (training);
    ``window(i, batch, seq_len)`` reads deterministic consecutive
    windows (eval). Both return int32 (B, seq_len) host arrays built by
    the native gather when available.
    """

    def __init__(self, path: str):
        with open(path, "rb") as f:
            magic, version, code, count = _HDR.unpack(f.read(_HDR.size))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a PBST token file")
        if version != 1:
            raise ValueError(f"{path}: unsupported version {version}")
        if code not in _DTYPES:
            raise ValueError(f"{path}: bad dtype code {code}")
        self.path = path
        self.dtype = _DTYPES[code]
        self.itemsize = code
        self.n_tokens = int(count)
        self._mm = np.memmap(path, dtype=self.dtype, mode="r",
                             offset=_HDR.size, shape=(self.n_tokens,))
        self._base = self._mm.view(np.uint8).reshape(-1)
        from pbs_tpu_torch.runtime import native as native_mod

        self._nat = native_mod.load()

    def __len__(self) -> int:
        return self.n_tokens

    def _gather(self, starts: np.ndarray, seq_len: int) -> np.ndarray:
        """starts: (B,) token offsets -> (B, seq_len) int32."""
        B = len(starts)
        row_bytes = seq_len * self.itemsize
        # Validate up front on BOTH paths: the Python fallback would
        # otherwise return silently short rows from a tail slice.
        if len(starts) and (int(starts.min()) < 0
                            or int(starts.max()) + seq_len > self.n_tokens):
            raise IndexError("window exceeds corpus")
        if self._nat is not None:
            import ctypes

            out = np.empty(B * row_bytes, dtype=np.uint8)
            offs = (starts.astype(np.uint64) * self.itemsize)
            offs = np.ascontiguousarray(offs)
            n = self._nat.pbst_gather_rows(
                self._base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_uint64(self._base.size),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                B, ctypes.c_uint64(row_bytes),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if n != B:
                raise IndexError("window exceeds corpus")
            rows = out.view(self.dtype).reshape(B, seq_len)
        else:
            rows = np.stack([
                self._mm[s:s + seq_len] for s in starts
            ])
        return rows.astype(np.int32)

    def sample(self, batch: int, seq_len: int,
               rng: np.random.Generator) -> np.ndarray:
        if seq_len > self.n_tokens:
            raise ValueError("seq_len exceeds corpus")
        starts = rng.integers(0, self.n_tokens - seq_len + 1, size=batch)
        return self._gather(starts, seq_len)

    def window(self, index: int, batch: int, seq_len: int) -> np.ndarray:
        """Deterministic eval windows: consecutive, wrapping at the end."""
        span = self.n_tokens - seq_len + 1
        if span <= 0:
            raise ValueError("seq_len exceeds corpus")
        starts = (index * batch + np.arange(batch)) * seq_len % span
        return self._gather(starts.astype(np.int64), seq_len)

    def close(self) -> None:
        self._mm._mmap.close()
