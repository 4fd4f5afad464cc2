#!/bin/bash
# MSSG backup-divided round trip across 4 PROCIDs (analogue of the
# reference's examples/mssg/divided/all_enc_dec.sh — embarrassingly
# parallel per-subdomain processes).
set -e
cd "$(dirname "$0")"
export PYTHONPATH=../..:$PYTHONPATH

python - <<'EOF'
import numpy as np
nx, ny, nz, npx, npy, nds = 16, 12, 8, 2, 2, 3
nxl, nyl = nx//npx, ny//npy
i = np.arange(max(nx,ny,nz))
glob = [np.zeros((nz,ny,nx)) for _ in range(nds)]
glob[0].ravel()[:15] = 2000.0 + np.arange(15)
for k in range(1, nds):
    glob[k] = (10*k*np.sin(i[:nx]/7)[None,None,:]*np.cos(i[:ny]/5)[None,:,None]
               * np.sin(i[:nz]/9)[:,None,None] + 273.0)
for py in range(npy):
    for px in range(npx):
        with open(f"rst.p_{px+npx*py:04d}", "wb") as f:
            for k in range(nds):
                sub = glob[k][:, py*nyl:(py+1)*nyl, px*nxl:(px+1)*nxl]
                f.write(sub.astype(">f8").tobytes())
open("rst.nmlst","w").write(
    "&gridparam\n nx = 16, ny = 12, nr = 8,\n/\n"
    "&procparam\n nproc = 4, dim_size = 2,\n/\n"
    "&recparam\n var = 'time', rec = 1,\n var = 'u', rec = 2,\n"
    " var = 't', rec = 3,\n/\n")
print("wrote rst.p_0000..0003 + rst.nmlst")
EOF

for procid in 0 1 2 3; do
  python -m waverange.cli.mssg_enc rst .enc 2 2 1 1e-7 $procid
  python -m waverange.cli.mssg_dec rst .enc rstrec 2 2 1 $procid
done
ls -l rst_f*.enc rstrec.p_*
echo "round trip complete"
