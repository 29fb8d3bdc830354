"""Write the AV1 decoder's fixed tables into ``csrc/host/av1_tables.h``.

    python scripts/av1_tables.py [--check]

The AV1 default CDFs and the other fixed tables of the intra decoding
process, read out of ``libaom.so.3`` (3.6.0) and checked against the copy in
``libdav1d.so.6`` (6.6.0), both from ``/lib/x86_64-linux-gnu``. The package
uses only the committed header: a host without either library decodes AVIF
all the same. ``--check`` rewrites nothing and fails where the committed
header differs from what the libraries hold.

How the libraries store the tables:

- libaom keeps a CDF of n symbols as ``AOM_CDFn``: the n - 1 values
  inverted (32768 - x), then 0 (32768 inverted), then a 0 counter. Large
  tables are arrays in ``.rodata`` in their declared layout. The compiler
  moved some small ones into 16- and 32-byte literal chunks (a row's tail,
  or rows of one repeated value, are then stored by immediates in the code
  and are not in ``.rodata``) or into the immediates of the function that
  sets up a frame context; each segment below says where its rows start.
  Rows no segment covers are 32768 / n steps (placeholders for block sizes
  that never read the table), and the script holds them to that.
- dav1d keeps the coefficient CDFs as arrays whose rows are padded to a
  power of two (binary CDFs to 2 words) and the mode CDFs partly in such
  arrays and partly in 8-byte pieces of literal pools. A row is checked
  against dav1d word for word where it is found whole at its array's
  stride, else each run of 8 (or else 4, 2, or each word) of its words
  must be found in the file at any byte offset (the code's immediates
  included: dav1d sets some rows up that way): the header says how many rows of each table were found
  which way.

The header stores each CDF in the specification's form: the n - 1 values x
(not inverted), 32768, then the counter's 0; the tables of integers (the
filter-intra taps, the smooth weights, the directional derivatives, the
mode angles, the 4x4 scan, ``Div_Lut``, the 8-bit quantizer lookups) as
libaom stores them. Each carries the file offset it was read from.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "qwen_image_edit_streamdiffusion_tpu_torch" / "csrc" / "host" / "av1_tables.h"
LIBAOM = Path("/lib/x86_64-linux-gnu/libaom.so.3")
LIBDAV1D = Path("/lib/x86_64-linux-gnu/libdav1d.so.6")

# name: (outer dims, symbols, [(first row, libaom file offset, rows, stride in words)
# or (row, [(libaom file offset, words), ...]) for a row kept in pieces])
# Rows are flattened over the outer dims in C order. The dims are the
# specification's (libaom's where it keeps a context the specification
# leaves out: the second row of each Eob_Pt table is a placeholder).
CDFS = {
    # --- block syntax of an intra frame ---
    "Partition_W8": ((4,), 4, [(0, 0x443ba0, 4, 11)]),
    "Partition_W16": ((4,), 10, [(0, 0x443bf8, 4, 11)]),
    "Partition_W32": ((4,), 10, [(0, 0x443c50, 4, 11)]),
    "Partition_W64": ((4,), 10, [(0, 0x443ca8, 4, 11)]),
    "Partition_W128": ((4,), 8, [(0, 0x443d00, 4, 11)]),
    "Intra_Frame_Y_Mode": ((5, 5), 13, [(0, 0x444080, 25, 14)]),
    "Uv_Mode_Cfl_Not_Allowed": ((13,), 13, [(0, 0x443d60, 13, 15)]),
    "Uv_Mode_Cfl_Allowed": ((13,), 14, [(0, 0x443ee6, 13, 15)]),
    "Angle_Delta": ((8,), 7, [(0, 0x444460, 8, 8)]),
    "Filter_Intra": ((22,), 2, [(0, 0x444a20, 11, 3), (16, 0x444a60, 6, 3)]),
    "Filter_Intra_Mode": ((), 5, [(0, 0x1C9650, 1, 5)]),
    "Cfl_Sign": ((), 8, [(0, 0x444c50, 1, 8)]),
    "Cfl_Alpha": ((6,), 16, [(0, 0x444c60, 5, 17), (5, [(0x444d0a, 11), (0x444d24, 4)])]),
    "Skip": ((3,), 2, [(0, 0x444b80, 3, 3)]),
    "Segment_Id": ((3,), 8, [(0, 0x444ba0, 3, 8)]),
    "Delta_Q": ((), 4, [(0, 0x444c30, 1, 5)]),
    "Delta_Lf": ((), 4, [(0, 0x444c3a, 1, 5)]),
    # --- coefficients: [q context][tx size][plane type]... ---
    "Txb_Skip": ((4, 5, 13), 2, [(0, 0x441440, 260, 3)]),
    "Eob_Pt_16": ((4, 2, 2), 5, [(0, 0x440b00, 16, 6)]),
    "Eob_Pt_32": ((4, 2, 2), 6, [(0, 0x440a20, 16, 7)]),
    "Eob_Pt_64": ((4, 2, 2), 7, [(0, 0x440920, 16, 8)]),
    "Eob_Pt_128": ((4, 2, 2), 8, [(0, 0x440800, 16, 9)]),
    "Eob_Pt_256": ((4, 2, 2), 9, [(0, 0x4406c0, 16, 10)]),
    "Eob_Pt_512": ((4, 2, 2), 10, [(0, 0x440560, 16, 11)]),
    "Eob_Pt_1024": ((4, 2, 2), 11, [(0, 0x4403e0, 16, 12)]),
    "Eob_Extra": ((4, 5, 2, 9), 2, [(0, 0x440bc0, 360, 3)]),
    "Dc_Sign": ((4, 2, 3), 2, [(0, 0x441a60, 24, 3)]),
    "Coeff_Base_Eob": ((4, 5, 2, 4), 3, [(0, 0x439c60, 160, 4)]),
    "Coeff_Base": ((4, 5, 2, 42), 4, [(0, 0x43a160, 1680, 5)]),
    "Coeff_Br": ((4, 5, 2, 21), 4, [(0, 0x43e300, 840, 5)]),
    # --- for the later slices: lossy frames (2B), screen content, motion ---
    "Intra_Tx_Type_Set1": ((4, 13), 7, [(0, 0x442dc8, 52, 17)]),
    "Intra_Tx_Type_Set2": ((4, 13), 5, [(0, 0x4434b0, 52, 17)]),
    "Tx_8x8": ((3,), 2, [(0, 0x444bd0, 3, 4)]),
    "Tx_16x16": ((3,), 3, [(0, 0x444be8, 3, 4)]),
    "Tx_32x32": ((3,), 3, [(0, 0x444c00, 3, 4)]),
    "Tx_64x64": ((3,), 3, [(0, 0x444c18, 3, 4)]),
    "Palette_Y_Size": ((7,), 7, [(0, 0x444380, 7, 8)]),
    "Palette_Uv_Size": ((7,), 7, [(0, 0x4443f0, 7, 8)]),
    "Palette_Y_Mode": ((7, 3), 2, [(0, 0x444550, 19, 3), (19, 0x4445c4, 2, 3)]),
    "Palette_Uv_Mode": ((2,), 2, [(0, 0x1C904D, 2, 3)]),
    **{f"Palette_Size_{k + 2}_{plane}_Color": ((5,), k + 2, [(0, base + 90 * k, 5, 9)])
       for plane, base in (("Uv", 0x441cc0), ("Y", 0x441f40)) for k in range(7)},
    "Intrabc": ((), 2, [(0, 0x1C9B54, 1, 3)]),
    "Mv_Joint": ((), 4, [(0, 0x444d40, 1, 5)]),
    "Mv_Class": ((2,), 11, [(0, 0x444d4a, 1, 12), (1, 0x444dd4, 1, 12)]),
    "Mv_Class0_Fr": ((2, 2), 4, [(0, 0x444d62, 2, 5), (2, 0x444dec, 2, 5)]),
    "Mv_Fr": ((2,), 4, [(0, 0x444d76, 1, 5), (1, 0x444e00, 1, 5)]),
    "Mv_Sign": ((2,), 2, [(0, 0x444d80, 1, 3), (1, 0x444e0a, 1, 3)]),
    "Mv_Class0_Hp": ((2,), 2, [(0, 0x444d86, 1, 3), (1, 0x444e10, 1, 3)]),
    "Mv_Hp": ((2,), 2, [(0, 0x444d8c, 1, 3), (1, 0x444e16, 1, 3)]),
    "Mv_Class0_Bit": ((2,), 2, [(0, 0x444d92, 1, 3), (1, 0x444e1c, 1, 3)]),
    "Mv_Bit": ((2, 10), 2, [(0, 0x444d98, 10, 3), (10, 0x444e22, 10, 3)]),
}
# rows the code sets by immediates that are not in the file (placeholders of
# block sizes that never read the table)
PLACEHOLDER_OK = {"Filter_Intra": range(11, 16)}

# integer tables: name: (C type, libaom offset, numpy dtype, count)
INTS = {
    "Filter_Intra_Taps": ("int8_t", 0x478920, "i1", 5 * 8 * 8),
    "Sm_Weights": ("uint8_t", 0x42d9a8, "u1", 256),
    "Dr_Intra_Derivative": ("uint16_t", 0x478a80, "<u2", 90),
    "Mode_To_Angle": ("uint8_t", 0x478b38, "u1", 13),
    "Default_Scan_4x4": ("int16_t", 0x4854d0, "<i2", 16),
    "Div_Lut": ("uint16_t", 0x487b20, "<u2", 257),
    "Dc_Qlookup_8": ("int16_t", 0x477660, "<i2", 256),
    "Ac_Qlookup_8": ("int16_t", 0x477060, "<i2", 256),
}


def _rodata(data: bytes):
    """(start, end) file offsets of .rodata, from the ELF section headers."""
    import struct

    shoff = struct.unpack_from("<Q", data, 0x28)[0]
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", data, 0x3A)
    strtab = struct.unpack_from("<Q", data, shoff + shstrndx * shentsize + 0x18)[0]
    for i in range(shnum):
        base = shoff + i * shentsize
        name_off = struct.unpack_from("<I", data, base)[0]
        name = data[strtab + name_off:data.index(b"\0", strtab + name_off)]
        if name == b".rodata":
            off, size = struct.unpack_from("<QQ", data, base + 0x18)
            return off, off + size
    raise ValueError("no .rodata section")


def read_cdfs(aom: bytes) -> dict:
    """Each CDF table in the specification's form, (rows, symbols + 1)
    uint16, and where each row came from."""
    out = {}
    for name, (dims, n, segments) in CDFS.items():
        rows = int(np.prod(dims)) if dims else 1
        table = np.zeros((rows, n + 1), np.int64)
        table[:, :n - 1] = [(32768 * (k + 1)) // n for k in range(n - 1)]
        table[:, n - 1] = 32768
        covered = set()
        for seg in segments:
            if len(seg) == 2:  # one row in pieces
                first, pieces = seg
                parts = [np.frombuffer(aom, "<u2", k, off) for off, k in pieces]
                reads = [(0, np.concatenate(parts).astype(np.int64), pieces[0][0])]
            else:
                first, off, count, stride = seg
                reads = [(r, np.frombuffer(aom, "<u2", n - 1, off + 2 * stride * r).astype(np.int64),
                          off + 2 * stride * r) for r in range(count)]
            for r, words, off in reads:
                values = 32768 - words
                if not (np.all(np.diff(values) > 0) and values[0] > 0 and values[-1] < 32768):
                    raise ValueError(f"{name} row {first + r} at {off:#x}: "
                                     f"not a CDF: {values.tolist()}")
                table[first + r, :n - 1] = values
                covered.add(first + r)
        missing = set(range(rows)) - covered
        allowed = set(PLACEHOLDER_OK.get(name, ()))
        if missing - allowed:
            raise ValueError(f"{name}: rows {sorted(missing - allowed)} not read")
        out[name] = (dims, n, table)
    return out


def uniform_rows(n: int) -> list:
    return [(32768 * (k + 1)) // n for k in range(n - 1)]


def check_dav1d(cdfs: dict, dav: bytes) -> dict:
    """Per table: rows found whole in dav1d (inverted, contiguous), rows
    found as runs of 4 words, placeholder rows; raises on a row not found."""
    lo, hi = _rodata(dav)
    ro = dav[lo:hi]
    report = {}
    for name, (dims, n, table) in cdfs.items():
        whole = pieces = uniform = 0
        for r, row in enumerate(table):
            values = row[:n - 1]
            inv = (32768 - values).astype("<u2")
            if values.tolist() == uniform_rows(n):
                uniform += 1
                continue
            if _found(ro, inv.tobytes()):
                whole += 1
                continue
            if n == 2 and _found(ro, inv.tobytes() + b"\0\0"):
                whole += 1  # a binary CDF beside its counter
                continue
            if any(all(dav.find(inv[i:i + k].tobytes()) >= 0 for i in range(0, len(inv), k))
                   for k in (8, 4, 2, 1)):
                pieces += 1
                continue
            raise ValueError(f"{name} row {r} {values.tolist()} is not in libdav1d")
        report[name] = {"whole": whole, "pieces": pieces, "uniform": uniform}
    return report


def _found(buf: bytes, pat: bytes) -> bool:
    i = buf.find(pat)
    while i >= 0:
        if i % 2 == 0:
            return True
        i = buf.find(pat, i + 1)
    return False


def read_ints(aom: bytes) -> dict:
    return {name: (ctype, off, np.frombuffer(aom, dt, count, off).astype(np.int64))
            for name, (ctype, off, dt, count) in INTS.items()}


def _c_array(values, per_line: int = 16) -> str:
    vals = [str(int(v)) for v in values]
    lines = [", ".join(vals[i:i + per_line]) for i in range(0, len(vals), per_line)]
    return "{\n    " + ",\n    ".join(lines) + "\n}"


def header(cdfs: dict, ints: dict, report: dict) -> str:
    out = [
        "// AV1's default CDFs and the fixed tables of the intra decoding process.",
        "// Written by scripts/av1_tables.py from libaom.so.3 (3.6.0), each CDF checked",
        "// against libdav1d.so.6 (6.6.0); do not edit. A CDF of n symbols is stored as",
        "// the specification stores it: n - 1 values, 32768, then the counter's 0.",
        "#pragma once",
        "#include <stdint.h>",
        "",
        "namespace av1tab {",
        "",
    ]
    for name, (dims, n, table) in cdfs.items():
        segs = ", ".join(f"row {seg[0]} in pieces at " + " and ".join(f"{o:#x}" for o, _ in seg[1])
                         if len(seg) == 2 else f"rows {seg[0]}-{seg[0] + seg[2] - 1} at {seg[1]:#x}"
                         for seg in CDFS[name][2])
        rep = report.get(name, {})
        out.append(f"// {name}: libaom {segs}; dav1d: {rep.get('whole', 0)} rows whole, "
                   f"{rep.get('pieces', 0)} in pieces, {rep.get('uniform', 0)} uniform")
        shape = "".join(f"[{d}]" for d in dims) + f"[{n + 1}]"
        flat = table.reshape(-1)
        out.append(f"static const uint16_t Default_{name}_Cdf{shape} = {_c_array(flat, n + 1)};")
        out.append("")
    for name, (ctype, off, values) in ints.items():
        out.append(f"// {name}: libaom at {off:#x}")
        out.append(f"static const {ctype} {name}[{len(values)}] = {_c_array(values)};")
        out.append("")
    out.append("}  // namespace av1tab")
    return "\n".join(out) + "\n"


def build() -> str:
    aom = LIBAOM.read_bytes()
    cdfs = read_cdfs(aom)
    report = check_dav1d(cdfs, LIBDAV1D.read_bytes())
    return header(cdfs, read_ints(aom), report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    text = build()
    if args.check:
        if OUT.read_text() != text:
            print(f"{OUT} differs from the libraries' tables", file=sys.stderr)
            return 1
        print("av1_tables.h equals the libraries' tables")
        return 0
    OUT.write_text(text)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
