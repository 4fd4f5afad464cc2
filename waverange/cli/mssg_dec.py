"""wrmssgdec CLI (reference src/mssg/mssg_dec.cpp:99-138).

Modes: 7 positional argv
(IN_PREFIX EXT OUT_PREFIX TYPE PRECISION ENDIANFLIP PROCID) or stdin.

Deviation (deliberate): the reference decoder's prompt advertises an
`.enc` default for the extension but never applies it (mssg_dec.cpp:96
declares ext_name with no initializer, unlike the encoder's
mssg_enc.cpp:102), so an empty answer aborts on a missing `_h` file.
We apply the advertised default instead; every input that worked with
the reference behaves identically.

Two more reference prompt/initializer mismatches, mirrored to the
EFFECTIVE behavior: an empty data-type answer yields float — the
prompt says [2] but the initializer is ``iouttype = 1``
(mssg_dec.cpp:92) and an empty line leaves it unchanged.  An empty
endian answer is undefined behavior in the reference
(``flag_convertendian`` is uninitialized, mssg_dec.cpp:72); we use 1,
matching the advertised default.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

from ..device import configure_jax
from ..io.mssg import decode_mssg


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    backend = os.environ.get("WR_BACKEND", "native")
    if backend != "native":
        configure_jax()  # x64 and the compile cache
    if len(argv) == 7:
        in_prefix, ext, out_prefix, bar, bar2, bar3, bar4 = argv
    else:
        print("usage: mssg_dec ENCODED_NAME_PREFIX ENCODED_NAME_EXT "
              "EXTRACTED_NAME_PREFIX TYPE PRECISION ENDIANFLIP PROCID")

        def ask(p, d=""):
            print(p, end="", flush=True)
            line = sys.stdin.readline().rstrip("\r\n")
            return line if line else d

        in_prefix = ask("Enter encoded data file name prefix []: ")
        # deviation: apply the advertised .enc default (see module doc);
        # argv mode passes the extension verbatim, like the reference.
        ext = ask("Enter encoded data file extension name [.enc]: ",
                  ".enc")
        out_prefix = ask("Enter extracted data file name prefix []: ")
        bar = ask("Enter file type (0/1/2) [0]: ", "0")
        bar2 = ask("Enter extracted data type (1: float; 2: double) [2]: ",
                   "1")  # effective reference default (see module doc)
        bar3 = ask("Enter endian conversion (0/1) [1]: ", "1")
        bar4 = ask("Enter id of this proc [0]: ", "0")
    decode_mssg(in_prefix, ext, out_prefix, int(bar or 0),
                int(bar2 or 1), bool(int(bar3 or 1)), int(bar4 or 0),
                backend=backend)
    print("=== End of decompression ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
