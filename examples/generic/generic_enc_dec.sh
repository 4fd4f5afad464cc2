#!/bin/bash
# Generic round trip (analogue of the reference's
# examples/generic/generic_enc_dec.sh): synthesize -> encode -> decode.
set -e
cd "$(dirname "$0")"
export PYTHONPATH=../..:$PYTHONPATH

python create_in_field.py

cat > inmeta <<'EOF'
&in_name = data.bin
&out_name = data.wrb
&header_name = data.wrh
&file_type = 0
&endian_conversion = 0
&number_of_field = 3
%field = 0
&input_data_type = 2
&nx = 32
&ny = 32
&nz = 32
&nh = 1
&order = 0
&compress = 1
&tolerance = 1e-6
/
%field = 1
&input_data_type = 2
&nx = 64
&ny = 64
&nz = 64
/
%field = 2
&input_data_type = 1
&nx = 1
&ny = 1
&nz = 1
&compress = 0
/
EOF

python -m waverange.cli.wrenc
python -m waverange.cli.wrdec data.wrb data.wrh datarec.bin 0 0
ls -l data.bin data.wrb datarec.bin
rm -f inmeta
echo "round trip complete"
