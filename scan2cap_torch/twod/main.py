"""The 2D baselines' entry point: ``python -m scan2cap_torch.twod.main``
(counterpart of ``scan2cap_tpu/twod/main.py``; reference
Scan2Cap-2D/main.py).

  --prep    build the (viewpoint, box source) feature store from renders
            ``<images_root>/<sample_id>.jpg|.png`` and a box JSON
            ``{sample_id: [{box, is_target}, ...]}``, with the ResNet of
            ``--resnet_pth`` (else ``make_resnet_extractor``'s routes);
  --train   train ``--model snt|tdbu`` (Adam, no weight decay; the gt-mode
            caption loss) and save ``outputs/2d_{model}_{tag}/ckpt/best.pt``;
            with ``--model retr``, build the retrieval bank;
  --eval    greedy captions of the val split from that checkpoint, scored
            (BLEU-4, CIDEr, ROUGE-L, METEOR).

The JAX CLI's flags, plus ``--device`` (default ``cuda``): the ResNet and
the decoders run on the card unless ``--device cpu`` is given.  Paths as in
the JAX package: ``SCAN2CAP_DATA`` (ScanRefer splits, ``glove.p``),
``SCAN2CAP_OUTPUT``, and ``SCAN2CAP_2D_DATA`` for the store.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--prep", action="store_true", help="build feature DBs")
    p.add_argument("--images_root", type=str, default=None,
                   help="--prep input: <root>/<sample_id>.jpg viewpoint "
                        "renders (sample_id = scene-object_ann)")
    p.add_argument("--resnet_pth", type=str, default=None,
                   help="--prep: torchvision resnet101 .pth for the feature "
                        "extractor (twod/resnet.py)")
    p.add_argument("--boxes", type=str, default=None,
                   help="--prep input: json {sample_id: [{box, is_target}]}")
    p.add_argument("--train", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--exp_type", type=str, default="nonretrieval")
    p.add_argument("--viewpoint", type=str, default="annotated")
    p.add_argument("--box", type=str, default="oracle")
    p.add_argument("--model", type=str, default="snt",
                   choices=["snt", "tdbu", "retr"])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def build_model(cfg, num_vocabs, device="cuda", seed: int = 0):
    """The decoder of ``cfg.model`` with seeded random weights
    (``models.layers.seeded_init``) on ``device``."""
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.models.layers import seeded_init
    from scan2cap_torch.twod.models import ShowAndTell2D, ShowAttendAndTell2D

    if cfg.model == "snt":
        feat = cfg.global_feat_size + (cfg.target_feat_size
                                       if cfg.add_target else 0)
        model = ShowAndTell2D(num_vocabs=num_vocabs, emb_size=cfg.emb_size,
                              feat_size=feat, hidden_size=cfg.hidden_size,
                              max_desc_len=cfg.max_desc_len,
                              add_target=cfg.add_target)
    elif cfg.model == "tdbu":
        model = ShowAttendAndTell2D(
            num_vocabs=num_vocabs, emb_size=cfg.emb_size,
            feat_size=cfg.global_feat_size + cfg.target_feat_size,
            context_size=cfg.target_feat_size, hidden_size=cfg.hidden_size,
            max_desc_len=cfg.max_desc_len, add_global=cfg.add_global)
    else:
        raise ValueError(cfg.model)
    seeded_init(model, seed)
    return model.to(resolve_device(device))


def load_render(images_root: str, sid: str) -> np.ndarray:
    """The render of ``sid`` as (H, W, 3) float32 in [0, 1] (Pillow)."""
    from PIL import Image
    for ext in (".jpg", ".png"):
        path = os.path.join(images_root, sid + ext)
        if os.path.exists(path):
            return np.asarray(Image.open(path).convert("RGB"),
                              np.float32) / 255.0
    raise FileNotFoundError(sid)


def prep(args, paths, cfg, scanrefer_train) -> str:
    from scan2cap_torch.twod.dataset import sample_id_of
    from scan2cap_torch.twod.preprocessing import (build_database,
                                                   make_resnet_extractor)

    if not (args.images_root and args.boxes):
        raise SystemExit(
            "--prep requires --images_root <renders> and --boxes <json>")
    with open(os.path.join(paths.data, "ScanRefer_filtered_val.json")) as f:
        samples = scanrefer_train + json.load(f)
    with open(args.boxes) as f:
        boxes_db = json.load(f)
    os.makedirs(os.path.dirname(cfg.db_path) or ".", exist_ok=True)
    extractor = make_resnet_extractor(pth=args.resnet_pth,
                                      device=args.device)
    t0 = time.perf_counter()
    out = build_database(
        cfg.db_path, samples,
        lambda e: load_render(args.images_root, sample_id_of(e)),
        lambda e: boxes_db.get(sample_id_of(e), []),
        extractor=extractor)
    print(f"wrote {out} ({len(samples)} samples, extractor "
          f"{extractor.backend}, {time.perf_counter() - t0:.1f} s)",
          flush=True)
    return out


def train(args, paths, cfg, train_ds, loader, device) -> str:
    import torch

    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.losses.pretrained import compute_cap_loss_gt
    from scan2cap_torch.train.checkpoints import CheckpointIO

    model = build_model(cfg, train_ds.num_vocabs, device, args.seed)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    it, times = 0, []
    for epoch in range(args.epoch):
        for batch in loader:
            t0 = time.perf_counter()
            b = to_device(batch, device)
            loss, acc = compute_cap_loss_gt(model(b, is_eval=False))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            loss, acc = float(loss.detach()), float(acc)
            times.append(time.perf_counter() - t0)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss {loss} at iteration {it}")
            it += 1
            if it % 10 == 0 or it == 1:
                print(f"[e{epoch} it{it}] loss {loss:.4f} "
                      f"acc {acc:.3f}", flush=True)
    out_dir = os.path.join(paths.output, f"2d_{args.model}_{args.tag}")
    CheckpointIO(os.path.join(out_dir, "ckpt")).save(
        "best", {"model": model.state_dict()})
    ms = 1e3 * float(np.median(times[1:] or times)) if times else 0.0
    print(f"saved to {out_dir} ({it} iterations, {ms:.2f} ms per step "
          f"median)", flush=True)
    return out_dir


def evaluate(args, paths, cfg, train_ds, glove, device) -> dict:
    import torch

    from scan2cap_torch.data.dataset import Loader
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.eval.eval_helper import decode_caption, score_captions
    from scan2cap_torch.train.checkpoints import CheckpointIO
    from scan2cap_torch.twod.dataset import TwoDDataset

    with open(os.path.join(paths.data, "ScanRefer_filtered_val.json")) as f:
        scanrefer_val = json.load(f)
    val_ds = TwoDDataset(scanrefer_val, cfg, glove,
                         vocab=train_ds.vocabulary)
    val_loader = Loader(val_ds, args.batch_size, shuffle=False,
                        seed=args.seed, drop_last=False)
    model = build_model(cfg, train_ds.num_vocabs, device, args.seed)
    out_dir = os.path.join(paths.output, f"2d_{args.model}_{args.tag}")
    model.load_state_dict(CheckpointIO(os.path.join(out_dir, "ckpt"))
                          .restore("best")["model"], strict=True)
    model.eval()
    table = torch.as_tensor(train_ds.emb_table).to(device)

    corpus, candidates = {}, {}
    for d in scanrefer_val:
        key = "{}|{}|{}".format(d["scene_id"], d["object_id"],
                                d["object_name"])
        corpus.setdefault(key, []).append(
            "sos " + " ".join(d["token"][:cfg.max_desc_len]) + " eos")
    idx2word = val_ds.vocabulary["idx2word"]
    t0, batches = time.perf_counter(), 0
    for batch in val_loader:
        b = to_device(batch, device)
        b["glove_emb_table"] = table
        with torch.no_grad():
            caps = model(b, is_eval=True)["lang_cap"].cpu().numpy()
        batches += 1
        for i in range(caps.shape[0]):
            e = val_ds.scanrefer[int(batch["dataset_idx"][i])]
            key = "{}|{}|{}".format(e["scene_id"], e["object_id"],
                                    e["object_name"])
            candidates[key] = [decode_caption(caps[i], idx2word)]
    decode_s = time.perf_counter() - t0
    bleu, cider, rouge, meteor = score_captions(corpus, candidates)
    print(f"[BLEU-4] {bleu[0][3]:.4f}  [CIDEr] {cider[0]:.4f}  "
          f"[ROUGE] {rouge[0]:.4f}  [METEOR] {meteor[0]:.4f}", flush=True)
    print(f"decoded {batches} batches in {decode_s:.2f} s", flush=True)
    return {"bleu-4": bleu[0][3], "cider": cider[0], "rouge": rouge[0],
            "meteor": meteor[0], "candidates": candidates}


def retrieval_bank(train_ds):
    from scan2cap_torch.twod.dataset import sample_id_of
    from scan2cap_torch.twod.models import Retrieval2D

    feats, lang = {}, {}
    for i, entry in enumerate(train_ds.scanrefer):
        d = train_ds[i]
        sid = sample_id_of(entry)
        feats[sid] = d["t_feat"]
        lang[sid] = d["lang_ids"]
    model = Retrieval2D(feats, lang)
    print(f"retrieval bank built: {len(feats)} samples", flush=True)
    return model


def main(argv=None):
    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.dataset import Loader
    from scan2cap_torch.data.vocab import load_glove
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.twod.conf import get_config
    from scan2cap_torch.twod.dataset import TwoDDataset

    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    device = resolve_device(args.device)
    paths = PathConfig()
    cfg = get_config(args.exp_type, args.viewpoint, args.box, args.model)
    with open(os.path.join(paths.data, "ScanRefer_filtered_train.json")) as f:
        scanrefer_train = json.load(f)

    if args.prep:
        return prep(args, paths, cfg, scanrefer_train)

    glove = load_glove(paths.glove)
    train_ds = TwoDDataset(scanrefer_train, cfg, glove)
    loader = Loader(train_ds, args.batch_size, shuffle=True, seed=args.seed)

    if args.model == "retr":
        # retrieval trains nothing: build the bank and stop
        return retrieval_bank(train_ds)
    if args.eval:
        return evaluate(args, paths, cfg, train_ds, glove, device)
    if args.train:
        return train(args, paths, cfg, train_ds, loader, device)
    return None


if __name__ == "__main__":
    main()
