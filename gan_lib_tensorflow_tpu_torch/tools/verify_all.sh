#!/usr/bin/env bash
# End-to-end verification drives for the PyTorch/CUDA port (the counterpart
# of tools/verify_all.sh; see README.md for the card's environment). Each
# step runs a REAL surface: the port's CLIs on the card, the dry runs and
# the DP x TP step on CPU ranks. It starts with the doctor and stops unless
# the card is healthy.
#
#   bash gan_lib_tensorflow_tpu_torch/tools/verify_all.sh     # OUT=... to move the runs
set -euo pipefail
cd "$(dirname "$0")/../.."
export PYTHONPATH="$PWD:${PYTHONPATH:-}"
OUT=${OUT:-${TMPDIR:-/tmp}/gantpu_verify}
mkdir -p "$OUT"

echo "== 0. doctor (quick) =="
if ! python -m gan_lib_tensorflow_tpu_torch.tools.doctor --quick > "$OUT/doctor.json"; then
  cat "$OUT/doctor.json"
  echo "doctor: the card is not healthy; stopping" >&2
  exit 1
fi
grep '"verdict"' "$OUT/doctor.json"

echo "== 1. SNGAN train (20 steps) + resume =="
python -m gan_lib_tensorflow_tpu_torch.cli.train_sngan --steps 20 --log-every 10 \
  --sample-every 20 --ckpt-every 20 --out-dir "$OUT/sngan" --data device-fake
python -m gan_lib_tensorflow_tpu_torch.cli.train_sngan --steps 30 --log-every 10 \
  --sample-every 30 --ckpt-every 30 --out-dir "$OUT/sngan" --data device-fake | grep resumed

echo "== 2. sample + serving export + evaluate from checkpoint =="
python -m gan_lib_tensorflow_tpu_torch.cli.sample --model sngan \
  --ckpt-dir "$OUT/sngan/ckpt" --out "$OUT/sngan/grid.png" --n 16 \
  --export-dir "$OUT/sngan/export"
test -s "$OUT/sngan/export/generator.pt2"
python -m gan_lib_tensorflow_tpu_torch.cli.evaluate --model sngan \
  --ckpt-dir "$OUT/sngan/ckpt" --n-samples 500 --n-real 500 --data fake

echo "== 3. ACGAN =="
python -m gan_lib_tensorflow_tpu_torch.cli.train_acgan --steps 5 --log-every 5 \
  --sample-every 1000000 --ckpt-every 1000000 --out-dir "$OUT/acgan" --data fake

echo "== 4. pix2pix train/test/export =="
python -m gan_lib_tensorflow_tpu_torch.cli.train_pix2pix --mode train --steps 4 \
  --log-every 2 --sample-every 4 --ckpt-every 4 --out-dir "$OUT/p2p" --data fake
python -m gan_lib_tensorflow_tpu_torch.cli.train_pix2pix --mode test \
  --out-dir "$OUT/p2p" --data fake --max-test-images 2
python -m gan_lib_tensorflow_tpu_torch.cli.train_pix2pix --mode export --out-dir "$OUT/p2p" --data fake

echo "== 5. PGGAN ladder 4->16 (s2d-from 8: every stage's top level runs the S2D path) =="
python -m gan_lib_tensorflow_tpu_torch.cli.train_pggan --final-resolution 16 \
  --width-mul 0.0625 --z-dim 64 --steps-per-phase 2 --log-every 1 --s2d-from 8 \
  --sample-every 1000000 --ckpt-every 1000000 --out-dir "$OUT/pggan" --data fake

echo "== 6. multi-rank dry run (8 CPU ranks) =="
python -m gan_lib_tensorflow_tpu_torch.dryrun 8

echo "== 6b. DP x TP via the stock CLI (data=4 x model=2 mesh, 8 CPU ranks) =="
OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone --nproc_per_node 8 \
  -m gan_lib_tensorflow_tpu_torch.cli.train_sngan --steps 2 --log-every 1 \
  --sample-every 2 --ckpt-every 2 --out-dir "$OUT/sngan_tp" --compute-dtype fp32 \
  --batch-size 8 --n-critic 1 --data fake --tp-shards 2 --device cpu
test -s "$OUT/sngan_tp/log.jsonl"

echo "== 7. north-star harness (smoke: synthetic stand-ins, UNGRADED) =="
python -m gan_lib_tensorflow_tpu_torch.cli.north_star --smoke \
  --out-dir "$OUT/north_star" | tee "$OUT/north_star.out"
grep -q "UNGRADED" "$OUT/north_star.out"

echo "== 8. step timing =="
python -m gan_lib_tensorflow_tpu_torch.tools.bench_step

echo "ALL VERIFICATION DRIVES PASSED"
