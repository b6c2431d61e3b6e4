#!/usr/bin/env bash
# GT-feature pipeline on the card: extract per-box features then train the
# caption-only model (the port's launch/extract_and_train_pretrained.sh,
# mirror of slurm/extract.job + train_pretrained.job).
set -euo pipefail
python -m scan2cap_torch.scripts.extract_gt_features --folder "$1" --split train --epoch 100
python -m scan2cap_torch.scripts.extract_gt_features --folder "$1" --split val --epoch 1
python -m scan2cap_torch.scripts.train_pretrained --mode gt --use_topdown --use_relation \
    --num_graph_steps 2 --num_locals 10 --tag "${TAG:-pretrained_gt}"
