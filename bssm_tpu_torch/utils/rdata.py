"""Minimal reader for R .rda / .rds files (RDX2/RDX3 XDR format).

The port's own copy of ``bssm_tpu/utils/rdata.py`` (numpy only): just
enough of R's serialization grammar to load the R package's datasets
(numeric / ts vectors and matrices in ``data/*.rda``) and a ``saveRDS``'d
``KFAS::SSModel`` for ``as_bssm``.  Supports REALSXP / INTSXP / LGLSXP /
STRSXP / VECSXP, attributes, and compression by gzip / bzip2 / xz.
"""
from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from typing import Any, Dict

import numpy as np

# SEXP type codes
NILSXP, SYMSXP, LISTSXP = 0, 1, 2
CHARSXP, LGLSXP, INTSXP, REALSXP, CPLXSXP, STRSXP, VECSXP = \
    9, 10, 13, 14, 15, 16, 19
ALTREP = 238
NILVALUE = 254
GLOBALENV = 253
MISSINGARG = 251
BASEENV = 241
EMPTYENV = 242
REFSXP = 255


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0
        self.refs = []

    def u32(self) -> int:
        v = struct.unpack_from(">I", self.d, self.o)[0]
        self.o += 4
        return v

    def i32(self) -> int:
        v = struct.unpack_from(">i", self.d, self.o)[0]
        self.o += 4
        return v

    def f64(self, n) -> np.ndarray:
        v = np.frombuffer(self.d, dtype=">f8", count=n, offset=self.o)
        self.o += 8 * n
        return v.astype(np.float64)

    def i32s(self, n) -> np.ndarray:
        v = np.frombuffer(self.d, dtype=">i4", count=n, offset=self.o)
        self.o += 4 * n
        return v.astype(np.int32)

    def raw(self, n) -> bytes:
        v = self.d[self.o:self.o + n]
        self.o += n
        return v

    # ------------------------------------------------------------------
    def item(self):
        flags = self.u32()
        ptype = flags & 0xFF
        has_attr = bool(flags & (1 << 9))
        has_tag = bool(flags & (1 << 10))

        if ptype == NILVALUE or ptype == NILSXP:
            return None
        if ptype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if ptype == SYMSXP:
            name = self.item()
            self.refs.append(name)
            return name
        if ptype == CHARSXP:
            n = self.i32()
            if n == -1:
                return None
            return self.raw(n).decode("utf-8", "replace")
        if ptype == LISTSXP:
            # pairlist node: [attr] [tag] car cdr
            attr = self.item() if has_attr else None
            tag = self.item() if has_tag else None
            car = self.item()
            cdr = self.item()
            pairs = [(tag, car)]
            if isinstance(cdr, list):
                pairs.extend(cdr)
            elif cdr is not None:
                pairs.append((None, cdr))
            return pairs
        if ptype == LGLSXP or ptype == INTSXP:
            n = self.i32()
            v = self.i32s(n)
            out = v.astype(np.float64)
            out[v == -2147483648] = np.nan
            obj = out if ptype == LGLSXP else v
            return self._with_attrs(obj, has_attr)
        if ptype == REALSXP:
            n = self.i32()
            v = self.f64(n)
            return self._with_attrs(v, has_attr)
        if ptype == STRSXP:
            n = self.i32()
            v = [self.item() for _ in range(n)]
            return self._with_attrs(v, has_attr)
        if ptype == VECSXP:
            n = self.i32()
            v = [self.item() for _ in range(n)]
            return self._with_attrs(v, has_attr)
        if ptype == ALTREP:
            info = self.item()   # serialization state pairlist
            state = self.item()
            self.item()          # attributes / end marker
            return _decode_altrep(info, state)
        if ptype in (GLOBALENV, BASEENV, EMPTYENV, MISSINGARG):
            return None
        raise ValueError(f"unsupported SEXP type {ptype} at offset {self.o}")

    def _with_attrs(self, obj, has_attr):
        if not has_attr:
            return obj
        attrs_list = self.item()
        attrs: Dict[str, Any] = {}
        if attrs_list:
            for tag, val in attrs_list:
                if tag is not None:
                    attrs[tag] = val
        return _apply_attrs(obj, attrs)


def _decode_altrep(info, state):
    """Handle compact_intseq / wrap_* ALTREP forms."""
    name = None
    if isinstance(info, list) and info:
        first = info[0][1] if isinstance(info[0], tuple) else info[0]
        name = first if isinstance(first, str) else None
    if name == "compact_intseq":
        n, start, step = state
        return (start + step * np.arange(int(n))).astype(np.int32)
    # wrap_real / wrap_integer: state is (payload, metadata)
    if isinstance(state, list) and state:
        return state[0]
    return state


def _apply_attrs(obj, attrs):
    if "dim" in attrs:
        dim = np.asarray(attrs["dim"]).astype(int)
        obj = np.asarray(obj).reshape(tuple(dim), order="F")
    if "tsp" in attrs:
        obj = np.asarray(obj)
    if "names" in attrs and isinstance(obj, list):
        obj = dict(zip(attrs["names"], obj))
    return obj


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:2] == b"BZ":
        return bz2.decompress(raw)
    if raw[:5] == b"\xfd7zXZ":
        return lzma.decompress(raw)
    return raw


def load_rds(path: str) -> Any:
    """Load the single object stored in an .rds file (`saveRDS`) — e.g. a
    serialized `KFAS::SSModel` for `as_bssm`
    (the R package's `R/as_bssm.R`).  Same XDR grammar as .rda
    without the top-level named pairlist."""
    with open(path, "rb") as f:
        data = _decompress(f.read())
    r = _Reader(data)
    fmt = r.raw(2)
    if fmt[:1] != b"X":
        raise ValueError("only XDR format supported")
    ver = r.i32()      # serialization format version (2 or 3)
    r.i32()            # writer R version
    r.i32()            # min reader R version
    if ver >= 3:       # version 3 carries a native-encoding string
        n = r.i32()
        r.raw(n)
    return r.item()


def load_rda(path: str) -> Dict[str, Any]:
    """Load all objects from an .rda file into a dict."""
    with open(path, "rb") as f:
        data = _decompress(f.read())
    if not data.startswith(b"RDX2\n") and not data.startswith(b"RDX3\n"):
        raise ValueError("not an RDX2/RDX3 rda file")
    r = _Reader(data[5:])
    fmt = r.raw(2)
    if fmt[:1] != b"X":
        raise ValueError("only XDR format supported")
    r.i32()  # version
    r.i32()  # writer
    ver = r.i32()  # min reader
    if data.startswith(b"RDX3\n"):
        n = r.i32()
        r.raw(n)  # native encoding string
    top = r.item()
    out = {}
    if isinstance(top, list):
        for tag, val in top:
            if tag is not None:
                out[tag] = val
    return out
