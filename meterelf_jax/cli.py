"""CLI entry point (behavior contract: meterelf/_main.py).

Each image produces one line:
``<filename>: <%07.3f value | UNKNOWN <error message>>[ <debug dict>]``
byte-identical to the reference — including its quirk of printing an
empty value when the reading is exactly 0.000 (``if data.value`` treats
0.0 as falsy, _main.py:17).

Environment knobs (all additions over the reference):

- ``METERELF_BATCH_SIZE``: device batch size (default 64).
- ``METERELF_EXACT=0``: f32 fast mode (golden-identical output on the
  shipped corpora; see docs/parity.md).
- ``DEBUG`` (any token): appends the per-dial reading dict to each line
  and writes annotated overlay PNGs — the headless analog of the
  reference's cv2.imshow windows (meterelf/_reading.py:43-78) — into
  ``METERELF_DEBUG_DIR`` (default ``meterelf-debug``); the ``masks``
  mode additionally writes the precomputed per-dial masks
  (meterelf/_dial_data.py:50-54 analog).
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from . import debugging
from .api import MeterImageData, get_meter_values

USAGE = "Usage: {prog} PARAMETERS_FILE [IMAGE_FILE...]"


def format_result(data: MeterImageData, debug: bool = False) -> str:
    """Render one golden output line (contract documented above)."""
    value = f"{data.value:07.3f}" if data.value else ""  # 0.000 quirk
    error = f"UNKNOWN {data.error.get_message()}" if data.error else ""
    suffix = f" {data.meter_values!r}" if debug else ""
    return f"{data.filename}: {value}{error}{suffix}"


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = list(sys.argv if argv is None else argv)
    if len(args) < 2:
        raise SystemExit(USAGE.format(prog=args[0] if args else "meterelf"))
    params_file, filenames = args[1], args[2:]
    from .compile_cache import setup_compile_cache

    setup_compile_cache()

    batch_size = int(os.environ.get("METERELF_BATCH_SIZE", "64"))
    exact = os.environ.get("METERELF_EXACT", "1") != "0"
    debug = bool(debugging.DEBUG)

    debug_dir = os.environ.get("METERELF_DEBUG_DIR", "meterelf-debug")
    debug_params = None
    if debug:
        from . import debugviz
        from .params import load as load_params

        debug_params = load_params(params_file)
        if "masks" in debugging.DEBUG:
            debugviz.render_masks(debug_params, debug_dir)

    for data in get_meter_values(params_file, filenames,
                                 batch_size=batch_size, exact=exact):
        print(format_result(data, debug))
        if debug_params is not None and data.error is None:
            from . import debugviz

            debugviz.render_overlay(data.filename, debug_params, debug_dir)


if __name__ == "__main__":
    main()
