"""Unified CLI dispatcher: `python -m waverange <tool> [args...]`."""
import sys

TOOLS = {
    "wrenc": ("cli.wrenc", "generic encoder (raw / Fortran-sequential)"),
    "wrdec": ("cli.wrdec", "generic decoder"),
    "flusi-enc": ("cli.flusi_enc", "FluSI HDF5 encoder"),
    "flusi-dec": ("cli.flusi_dec", "FluSI HDF5 decoder"),
    "mssg-enc": ("cli.mssg_enc", "MSSG encoder (regular/united/divided)"),
    "mssg-dec": ("cli.mssg_dec", "MSSG decoder"),
    "bench": (None, "run the throughput benchmark (bench.py)"),
    "build-lib": ("native.libwaverange", "build drop-in libwaverange"),
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m waverange <tool> [args...]\n")
        for name, (_, desc) in TOOLS.items():
            print(f"  {name:10s} {desc}")
        return 0
    tool = sys.argv[1]
    if tool not in TOOLS:
        print(f"unknown tool: {tool}")
        return 2
    if tool == "bench":
        import runpy
        from pathlib import Path
        sys.argv = sys.argv[1:]
        runpy.run_path(str(Path(__file__).resolve().parents[1]
                           / "bench.py"), run_name="__main__")
        return 0
    mod, _ = TOOLS[tool]
    if tool == "build-lib":
        from .native.libwaverange import build_libwaverange
        print(build_libwaverange())
        return 0
    import importlib
    m = importlib.import_module(f"waverange.{mod}")
    return m.main(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())
