#!/usr/bin/env bash
# MaskVoteNet feature-extractor pretraining on the card (the port's
# launch/train_maskvotenet.sh, mirror of slurm/train_maskvotenet.job).
set -euo pipefail
python -m scan2cap_torch.scripts.train_maskvotenet --batch_size 16 --epoch 20 \
    --use_multiview --use_normal --tag "${TAG:-maskvotenet}"
