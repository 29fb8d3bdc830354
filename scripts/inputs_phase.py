"""Run ``chip_smoke.py``'s ``inputs`` phase alone, from a checkout.

    python scripts/inputs_phase.py ROOT [ROOT ...]

Each ROOT holds a ``chip_smoke.py`` and the package beside it; each runs in
a process of its own, in the order given, so two checkouts (say a parent
unpacked with ``git archive`` and this one, as parent, change, change,
parent) are timed on one host in one call. The phase decodes every
committed codec fixture against its manifest and times the 1024² decode
set; this prints its JSON lines, then one line a run of the TIFF rows',
the plain raster rows', the small decoders', the JPEG 2000 rows', the
rare formats', the CIELab and BC6H rows' and the lossless AVIF row's
multiples of the baseline JPEG (the small decoders', JPEG 2000's, the rare
formats', the CIELab and BC6H rows' and the AVIF row's ms too, and JPEG 2000's coded bits a pixel), the 2^24 Lab8
sweep's ms and whether its hash is Pillow's, and the phase's seconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# the decode set's plain raster rows, and the small decoders' and ZSTD TIFF's
RASTER = ("ppm", "tga_rle", "psd_rle", "qoi", "pcx", "sgi_rle")
SMALL = ("tiff_zstd_predictor", "sun_rle", "msp_v2", "xbm", "xpm", "icns_it32", "dds_rgb",
         "dds_rgb24", "dds_bc1", "dds_bc7")
JPEG2000 = ("jpeg2000_53", "jpeg2000_97")
# the rare formats' rows (chip_smoke.rare_decode_set)
RARE = ("im_rgb", "blp2_palette", "blp2_dxt1", "blp1_jpeg", "fits_8", "fits_gzip", "fli_brun",
        "ftex_dxt1", "gbr_rgba", "imt", "iptc_raw", "mcidas", "pcd", "pixar", "spider",
        "xvthumb")
# the CIELab and BC6H rows (chip_smoke.lab_decode_set)
LAB = ("tiff_lab", "psd_lab", "dds_bc6h", "dds_bc6hs")
# the lossless AVIF row (the committed 1024² fixture, 2x2 tiles)
AVIF = ("avif_lossless",)

RUN = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke
lines = []
chip_smoke.emit = lambda d: (lines.append(d), print(json.dumps(d), flush=True))
t0 = time.perf_counter()
chip_smoke.phase_inputs()
print(json.dumps({"inputs_s": time.perf_counter() - t0}), flush=True)
"""


def main(argv=None) -> int:
    roots = (argv if argv is not None else sys.argv[1:]) or [
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    for root in roots:
        root = os.path.abspath(root)
        run = subprocess.run([sys.executable, "-c", RUN, root], cwd=root, capture_output=True,
                             text=True)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            return run.returncode
        rows = [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]
        formats = next(r for r in rows if r.get("phase") == "inputs_decode_formats")
        print(json.dumps({
            "root": root, "inputs_s": next(r["inputs_s"] for r in rows if "inputs_s" in r),
            "fixtures": sum(r.get("phase") == "inputs_fixture" for r in rows),
            "baseline_jpeg_ms": formats["baseline_jpeg_ms"],
            "tiff_over_baseline": {k: v["over_baseline"] for k, v in formats["formats"].items()
                                   if k.startswith("tiff")},
            "raster_over_baseline": {k: v["over_baseline"] for k, v in formats["formats"].items()
                                     if k in RASTER},
            "small_ms": {k: v["ms"] for k, v in formats["formats"].items() if k in SMALL},
            "small_over_baseline": {k: v["over_baseline"] for k, v in formats["formats"].items()
                                    if k in SMALL},
            "jpeg2000_ms": {k: v["ms"] for k, v in formats["formats"].items() if k in JPEG2000},
            "jpeg2000_over_baseline": {k: v["over_baseline"]
                                       for k, v in formats["formats"].items() if k in JPEG2000},
            "jpeg2000_bits_per_pixel": {k: v["bytes"] * 8 / formats["size"] ** 2
                                        for k, v in formats["formats"].items() if k in JPEG2000},
            "rare_ms": {k: v["ms"] for k, v in formats["formats"].items() if k in RARE},
            "rare_over_baseline": {k: v["over_baseline"] for k, v in formats["formats"].items()
                                   if k in RARE},
            "lab_ms": {k: v["ms"] for k, v in formats["formats"].items() if k in LAB},
            "lab_over_baseline": {k: v["over_baseline"] for k, v in formats["formats"].items()
                                  if k in LAB},
            "avif_ms": {k: v["ms"] for k, v in formats["formats"].items() if k in AVIF},
            "avif_over_baseline": {k: v["over_baseline"] for k, v in formats["formats"].items()
                                   if k in AVIF},
            "lab_sweep": next(({"ms": r["ms"], "equal_to_pillow": r["equal_to_pillow"]}
                               for r in rows if r.get("phase") == "inputs_lab_sweep"), None),
            "write_s": formats["write_s"], "nvidia_smi": formats["nvidia_smi"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
