#!/bin/bash
# FluSI HDF5 round trip (analogue of the reference's
# examples/flusi/flusi_dec_enc.sh, with synthesized input instead of the
# OSF download — this environment has no network egress).
set -e
cd "$(dirname "$0")"
export PYTHONPATH=../..:$PYTHONPATH

python - <<'EOF'
import numpy as np, h5py
n = 64
i = np.arange(n)
fld = 10*np.sin(i/16)[None,None,:]*np.sin(i/16)[None,:,None]**2*np.cos(i/16)[:,None,None]
with h5py.File("ux_00010.h5", "w") as f:
    d = f.create_dataset("ux", data=fld)
    d.attrs.create("time", np.array([10.0]))
    d.attrs.create("viscosity", np.array([1e-3]))
    d.attrs.create("epsi", np.array([0.0]))
    d.attrs.create("domain_size", np.array([2*np.pi]*3))
    d.attrs.create("nxyz", np.array([n, n, n], np.int32))
print("wrote ux_00010.h5")
EOF

python -m waverange.cli.flusi_enc ux_00010.h5 compressed_00010.h5 0 1e-3
python -m waverange.cli.flusi_dec compressed_00010.h5 decompressed_00010.h5 0 2
ls -l ux_00010.h5 compressed_00010.h5 decompressed_00010.h5
echo "round trip complete"
