#!/usr/bin/env bash
# CI entry point — the analog of the reference's ci/compile_and_run.sh
# (build + ctest -j12).  Builds the native host kernels and runs the full
# suite on the virtual 8-device CPU mesh; chip_smoke.py and bench.py
# separately exercise the GPU path.
set -euo pipefail
cd "$(dirname "$0")/.."
python - <<'PY'
from mfmg_tpu import native
lib = native._load()
print("native kernels:", "built" if lib is not None else "UNAVAILABLE (numpy fallback)")
PY
exec python -m pytest tests/ -q "$@"
