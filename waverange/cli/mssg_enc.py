"""wrmssgenc CLI (reference src/mssg/mssg_enc.cpp:57-232).

Modes: `inmeta` file (&prefix_name/&ext_name/&file_type/&input_data_type/
&endian_conversion/&tolerance/&id_of_proc or old 7-line positional),
7 positional argv (PREFIX EXT TYPE PRECISION ENDIANFLIP TOLERANCE PROCID),
or stdin prompts. MSSG endian conversion defaults ON.

Default semantics mirror the reference exactly: the ".enc" extension
default (mssg_enc.cpp:102 initializer) survives only when the value is
ABSENT (missing &ext_name key / old-format file shorter than 2 lines) —
a present-but-empty line clobbers it via getline, so an empty stdin or
old-format answer means extension "" and files named `prefix_h`/
`prefix_f`. Numeric fields keep their defaults on empty input
(stringstream >> is a no-op on "").
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

from ..device import configure_jax
from ..io.mssg import encode_mssg


def _parse_inmeta(path: str):
    lines = open(path).read().splitlines()
    kv = {}
    found = False
    for raw in lines:
        s = raw.strip(" \t\v\r\n")
        if s and s[0] == "&":
            parts = s.split("=")
            if len(parts) != 2:
                raise ValueError(f"bad inmeta line: {s}")
            found = True
            kv[parts[0].strip().lower()] = parts[1].strip()
    if found:
        return (kv.get("&prefix_name", ""), kv.get("&ext_name", ".enc"),
                kv.get("&file_type", ""), kv.get("&input_data_type", ""),
                kv.get("&endian_conversion", ""), kv.get("&tolerance", ""),
                kv.get("&id_of_proc", ""))
    g = lambda i: lines[i] if i < len(lines) else ""
    ext = lines[1] if len(lines) > 1 else ".enc"  # absent line keeps default
    return g(0), ext, g(2), g(3), g(4), g(5), g(6)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    backend = os.environ.get("WR_BACKEND", "native")
    if backend != "native":
        configure_jax()  # x64 and the compile cache
    coder = os.environ.get("WR_CODER", "range")
    if os.path.exists("inmeta"):
        prefix, ext, bar, bar2, bar3, bar4, bar5 = _parse_inmeta("inmeta")
    elif len(argv) == 7:
        prefix, ext, bar, bar2, bar3, bar4, bar5 = argv
    else:
        print("usage: mssg_enc FILE_NAME_PREFIX ENCODED_NAME_EXT TYPE "
              "PRECISION ENDIANFLIP TOLERANCE PROCID")

        def ask(p, d=""):
            print(p, end="", flush=True)
            line = sys.stdin.readline().rstrip("\r\n")
            return line if line else d

        prefix = ask("Enter data file name prefix []: ")
        # verbatim, even empty: getline clobbers the .enc initializer
        ext = ask("Enter encoded file extension name [.enc]: ")
        bar = ask("Enter file type (0/1/2) [0]: ", "0")
        bar2 = ask("Enter input data type (1: float; 2: double) [2]: ", "2")
        bar3 = ask("Enter endian conversion (0/1) [1]: ", "1")
        bar4 = ask("Enter base cutoff relative tolerance [1e-16]: ",
                   "1e-16")
        bar5 = ask("Enter id of this proc [0]: ", "0")
    encode_mssg(prefix, ext, int(bar or 0), int(bar2 or 2),
                bool(int(bar3 or 1)), float(bar4 or 1e-16), int(bar5 or 0),
                backend=backend, coder=coder)
    print("=== End of compression ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
