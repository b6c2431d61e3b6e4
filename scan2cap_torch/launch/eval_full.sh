#!/usr/bin/env bash
# Caption + detection evaluation of a trained run on the card (the port's
# launch/eval_full.sh, mirror of slurm/eval.job).
set -euo pipefail
python -m scan2cap_torch.scripts.eval --folder "$1" --eval_caption --eval_detection
