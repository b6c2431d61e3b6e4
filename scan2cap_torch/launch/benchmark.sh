#!/usr/bin/env bash
# Offline benchmark prediction on the card + scoring (the port's
# launch/benchmark.sh, mirror of slurm/predict.job).
set -euo pipefail
python -m scan2cap_torch.benchmark.predict --folder "$1" --split val
python -m scan2cap_torch.benchmark.eval --path "outputs/$1/pred.json" \
    --gt_path "${SCAN2CAP_DATA:-data}/ScanRefer_filtered_val_gt_bbox.json"
