"""The benchmark's traffic: synthetic rooms in ScanNet's layout, made on
the device from the seed in a few large calls.

A room is a floor of background points with ``num_objects`` boxes of
ScanNet's classes (sized from the class means), each filled with points;
every labelled point votes to its box's centre.  Each scene carries the
keys and widths of the port's dataset batches: the point cloud with its
feature columns (normals and multiview features as seeded noise, then the
height above the floor), vote labels, padded box labels, GT corners and
rotations, the reference object and a random-token caption, and the
embedding table.  ``mask_votenet_batches`` adds the reference object's
mask as the last column and keeps its one box, as the MaskVoteNet dataset
does.  Every seed gives the same sizes; only the values differ.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from h100bench.reference.ops import MEAN_SIZE

_SX = (1, 1, -1, -1, 1, 1, -1, -1)
_SY = (1, -1, -1, 1, 1, -1, -1, 1)
_SZ = (1, 1, 1, 1, -1, -1, -1, -1)
SOS, EOS, FIRST_WORD = 2, 3, 4


def uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def embedding_table(g, num_vocabs: int, emb_size: int, device) -> torch.Tensor:
    """The vocabulary's embeddings, N(0, 0.01); row 0 (padding) zero."""
    table = torch.randn((num_vocabs, emb_size), generator=g,
                        device=device) * 0.1
    table[0] = 0.0
    return table


def rooms(g, S: int, cfg: Dict, num_objects: int, max_num_obj: int,
          table: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    """``S`` scenes at once, every key with a leading scene axis; the
    caption keys where a ``table`` of embeddings is given."""
    N, O, M = cfg["num_points"], num_objects, max_num_obj
    T = cfg["max_des_len"] + 2
    per = N // (2 * O)
    mean = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=device)

    xyz = torch.cat([uniform(g, (S, N, 2), -4.0, 4.0, device),
                     uniform(g, (S, N, 1), 0.0, 0.05, device)], -1)
    cls = torch.randint(0, len(MEAN_SIZE), (S, O), generator=g, device=device)
    size = mean[cls] * uniform(g, (S, O, 3), 0.8, 1.2, device)
    center = torch.cat([uniform(g, (S, O, 2), -3.0, 3.0, device),
                        size[..., 2:3] / 2 + 0.05], -1)
    lo, hi = center - size / 2, center + size / 2
    pts = lo[:, :, None] + (hi - lo)[:, :, None] * torch.rand(
        (S, O, per, 3), generator=g, device=device)
    xyz[:, :O * per] = pts.reshape(S, O * per, 3)
    pcenter = 0.5 * (pts.amin(2) + pts.amax(2))
    vote = (pcenter[:, :, None] - pts).reshape(S, O * per, 3)
    vote_label = torch.zeros((S, N, 9), device=device)
    vote_label[:, :O * per] = vote.repeat(1, 1, 3)
    vote_mask = torch.zeros((S, N), dtype=torch.int32, device=device)
    vote_mask[:, :O * per] = 1

    sign = torch.tensor([_SX, _SY, _SZ], dtype=torch.float32,
                        device=device).t()
    corners = sign * size[:, :, None] / 2 + center[:, :, None]
    theta = uniform(g, (S, O), 0.0, torch.pi, device)
    c, s = torch.cos(theta), torch.sin(theta)
    z, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                       torch.stack([z, z, one], -1)], -2)

    def pad(x, dtype=None):
        out = torch.zeros((S, M) + x.shape[2:], dtype=dtype or x.dtype,
                          device=device)
        out[:, :O] = x
        return out

    ref = torch.randint(0, O, (S,), generator=g, device=device)
    rows = torch.arange(S, device=device)
    ones = torch.ones((S, O), dtype=torch.int32, device=device)
    out = {
        "xyz": xyz, "per_object": per,
        "vote_label": vote_label, "vote_label_mask": vote_mask,
        "center_label": pad(center),
        "heading_class_label": pad(torch.zeros_like(ones)),
        "heading_residual_label": pad(torch.zeros_like(size[..., 0])),
        "size_class_label": pad(cls.to(torch.int32)),
        "size_residual_label": pad(size - mean[cls]),
        "sem_cls_label": pad(cls.to(torch.int32)),
        "box_label_mask": pad(torch.ones_like(size[..., 0])),
        "scene_object_ids": pad(torch.arange(O, dtype=torch.int32,
                                             device=device).expand(S, O)),
        "scene_object_rotations": pad(rot),
        "scene_object_rotation_masks": pad(ones),
        "gt_box_corner_label": pad(corners),
        "gt_box_masks": pad(ones),
        "gt_box_object_ids": pad(torch.arange(O, dtype=torch.int32,
                                              device=device).expand(S, O)),
        "ref_box_corner_label": corners[rows, ref],
        "ref_center_label": center[rows, ref],
        "ref_size_class_label": cls[rows, ref].to(torch.int32),
        "ref_size_residual_label": (size - mean[cls])[rows, ref],
        "object_id": ref.to(torch.int32),
        "ref": ref,
    }
    if table is None:
        return out
    words = torch.randint(3, cfg["max_des_len"], (S,), generator=g,
                          device=device)
    lang_len = words + 2
    slot = torch.arange(T, device=device)[None]
    ids = torch.randint(FIRST_WORD, table.shape[0], (S, T), generator=g,
                        device=device)
    ids = torch.where(slot == 0, SOS, ids)
    ids = torch.where(slot == lang_len[:, None] - 1, EOS, ids)
    ids = torch.where(slot >= lang_len[:, None], 0, ids).to(torch.int32)

    out.update(lang_ids=ids, lang_len=lang_len.to(torch.int32),
               lang_feat=table[ids.long()])
    return out


def point_cloud(g, r: Dict, cfg: Dict, extra: int, device) -> torch.Tensor:
    """xyz, the feature columns (normals and multiview as N(0, 0.01)),
    the height above the floor (its 0.99th percentile), ``extra`` zero
    columns."""
    xyz = r["xyz"]
    S, N, _ = xyz.shape
    noise = 3 * int(cfg["use_normal"]) + 128 * int(cfg["use_multiview"])
    cols = [xyz, torch.randn((S, N, noise), generator=g, device=device) * 0.1]
    if cfg["use_height"]:
        floor = torch.quantile(xyz[..., 2], 0.0099, dim=1, keepdim=True)
        cols.append((xyz[..., 2] - floor)[..., None])
    cols.append(torch.zeros((S, N, extra), device=device))
    return torch.cat(cols, -1)


def split(scenes: Dict[str, torch.Tensor], pool: int, batch: int
          ) -> List[Dict[str, torch.Tensor]]:
    """Scene-major tensors -> ``pool`` batches of ``batch`` scenes (views)."""
    return [{k: v[i * batch:(i + 1) * batch] for k, v in scenes.items()}
            for i in range(pool)]


def capnet_batches(seed: int, cfg: Dict, traffic: Dict, device
                   ) -> List[Dict[str, torch.Tensor]]:
    """The pool of CapNet batches of a traffic mix."""
    g = torch.Generator(device=device).manual_seed(seed)
    table = embedding_table(g, cfg["num_vocabs"], cfg["emb_size"], device)
    S = traffic["pool"] * traffic["batch"]
    r = rooms(g, S, cfg, traffic["num_objects"], cfg["max_num_obj"], table,
              device)
    scenes = {k: v for k, v in r.items()
              if k not in ("xyz", "per_object", "ref")}
    scenes["point_clouds"] = point_cloud(g, r, cfg, 0, device)
    batches = split(scenes, traffic["pool"], traffic["batch"])
    for b in batches:
        b["glove_emb_table"] = table
    return batches


def mask_votenet_batches(seed: int, cfg: Dict, traffic: Dict, device
                         ) -> List[Dict[str, torch.Tensor]]:
    """The pool of MaskVoteNet batches: the rooms with the reference
    object's mask as the last column, every point voting to the centre of
    that object's points, the labels of its one box."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = traffic["pool"] * traffic["batch"]
    O = traffic["num_objects"]
    r = rooms(g, S, cfg, O, O, None, device)
    pc = point_cloud(g, r, cfg, 1, device)
    per, ref, xyz = r["per_object"], r["ref"], r["xyz"]
    point = torch.arange(pc.shape[1], device=device)[None]
    inside = (point >= ref[:, None] * per) & (point < (ref[:, None] + 1) * per)
    pc[..., -1] = inside.float()
    rows = torch.arange(S, device=device)
    pts = xyz[:, :O * per].reshape(S, O, per, 3)[rows, ref]
    center = 0.5 * (pts.amin(1) + pts.amax(1))
    scenes = {
        "point_clouds": pc,
        "center_label": r["center_label"][rows, ref][:, None],
        "heading_class_label": torch.zeros((S, 1), dtype=torch.int32,
                                           device=device),
        "heading_residual_label": torch.zeros((S, 1), device=device),
        "size_class_label": r["size_class_label"][rows, ref][:, None],
        "size_residual_label": r["size_residual_label"][rows, ref][:, None],
        "sem_cls_label": r["sem_cls_label"][rows, ref][:, None],
        "box_label_mask": torch.ones((S, 1), device=device),
        "vote_label": (center[:, None] - xyz).repeat(1, 1, 3),
        "vote_label_mask": torch.ones(xyz.shape[:2], dtype=torch.int32,
                                      device=device),
        "bbox_corner_label": r["ref_box_corner_label"],
    }
    return split(scenes, traffic["pool"], traffic["batch"])

