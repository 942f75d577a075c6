#!/bin/sh
# Full local check battery. CPU-only parts always run; the on-card smoke run
# and the headline bench run when JAX finds a GPU (skip with S3D_SKIP_GPU=1).
set -e
cd "$(dirname "$0")/.."

echo "== native build =="
make -C native

echo "== test suite (CPU, 8-device virtual mesh) =="
python -m pytest tests/ -q

echo "== driver hooks (dryrun self-provisions the 8-device virtual mesh) =="
python -c "
import __graft_entry__ as g
g.dryrun_multichip(8)"
JAX_PLATFORMS=cpu python -c "
import __graft_entry__ as g
fn, args = g.entry(); print('entry:', fn(*args).shape)"

if [ "${S3D_SKIP_GPU:-0}" != "1" ] && python -c "
import jax, sys; sys.exit(jax.default_backend() != 'gpu')"; then
    echo "== on-card smoke run =="
    python chip_smoke.py
    echo "== headline bench =="
    python bench.py
fi
echo "CI OK"
