#!/usr/bin/env bash
# Canonical full-model training on the card (the port's launch/train_full.sh,
# mirror of slurm/train.job:24): multiview + normal + topdown + relation +
# orientation, 2 graph steps, 10 locals, warm-started from the released
# VoteNet weights, named by path.
set -euo pipefail
python -m scan2cap_torch.scripts.train \
    --batch_size 16 --epoch 50 --val_step 2000 \
    --use_multiview --use_normal --use_topdown --use_relation \
    --use_orientation --num_graph_steps 2 --num_locals 10 \
    --use_pretrained "${PRETRAINED:-pretrained/PRETRAIN_VOTENET_XYZ_MULTIVIEW_NORMAL/model.pth}" \
    --tag "${TAG:-full}"
