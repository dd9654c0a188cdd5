#!/usr/bin/env bash
# The port's benchmark harness at full size on one CUDA card: every mode
# of `python -m imageclust_tpu_torch.cli bench` that PERF.md section 5
# records, one process each, in this order.
#
#     tools/bench_port.sh [OUT_DIR]      (default build/bench)
#
# Each run's stdout (its one JSON line) and stderr (the detail line and
# the log) go to OUT_DIR/<name>.out and .err; this script prints the card,
# then one line per run: its name, exit code, seconds and result line.
# Runs go on after a failure; the script exits non-zero if any failed.
set -u
cd "$(dirname "$0")/.."
out="${1:-build/bench}"
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'

failed=0
run() {
  local name="$1"; shift
  local t0=$SECONDS
  python -m imageclust_tpu_torch.cli bench "$@" \
    > "$out/$name.out" 2> "$out/$name.err"
  local rc=$?
  [ $rc -eq 0 ] || failed=1
  echo "$name rc=$rc s=$((SECONDS - t0)) $(tail -n 1 "$out/$name.out")"
  grep -h '^detail: ' "$out/$name.err" | cut -c 1-1500
}

run e2e
run e2e_stream_resnet50 --e2e-stream --n 100000 --work-dir "$out/stream_rn50"
run e2e_stream_vit_b32 --e2e-stream --model vit_b32 --n 10000 \
  --work-dir "$out/stream_vit"
run cluster_1m --cluster-only --n 1000000 --d 64
run embed_resnet50 --embed-only --model resnet50
run embed_resnet50_int8 --embed-only --model resnet50 --quantize int8
run embed_vit_b32 --embed-only --model vit_b32
run embed_vit_b32_int8 --embed-only --model vit_b32 --quantize int8
run decode --decode
run e2e_real_20k --e2e-real --n 20000 --data-dir "$out/jpegs"
run quality --quality
rm -rf "$out/stream_rn50" "$out/stream_vit" "$out/jpegs"
exit $failed
