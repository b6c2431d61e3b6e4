"""Top-down caption decoder
(counterpart of ``scan2cap_tpu/models/caption.py:36-98, 247-614``; reference
models/caption_module.py:16-38, 202-592).

``forward_sample_batch`` is the training path: one target proposal per
sample (the argmax-IoU proposal against the GT reference box), decoded
teacher-forced for ``max_des_len + 1`` steps with attention over all K
proposals, masked to the target's ``num_locals`` locals.

``forward_scene_batch`` decodes a caption for every proposal, free-running
from the sos embedding, with attention over each target's ``num_locals``
local slots (``_decode_scene_local``, caption.py:462-580): every other
proposal is -1e30-masked in the reference, so its softmax weight is
exactly 0 and scoring only the local slots is the same math.  The plain
``SceneCaptionModule`` and the full-K scene decode are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from typing import Tuple

from scan2cap_torch.models.graph import (bbox_centers, mask_and_topk_locals,
                                         norm3, query_locals_dense)
from scan2cap_torch.models.layers import GRUCell
from scan2cap_torch.ops.boxes import box3d_iou_batch


def select_target(data_dict: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax-IoU proposal per sample against the GT reference box
    (caption_module.py:16-38).  Returns (target_ids (B,) int32,
    target_ious (B,))."""
    pred_bbox = data_dict["bbox_corner"].detach()          # (B, K, 8, 3)
    gt_bbox = data_dict["ref_box_corner_label"]            # (B, 8, 3)
    ious = box3d_iou_batch(pred_bbox, gt_bbox[:, None])    # (B, K)
    target_ids = torch.argmax(ious, dim=1)                 # first max wins
    target_ious = torch.gather(ious, 1, target_ids[:, None])[:, 0]
    return target_ids.to(torch.int32), target_ious


def query_locals_for_targets(corners: torch.Tensor,
                             object_masks: torch.Tensor,
                             target_ids: torch.Tensor, num_locals: int,
                             query_mode: str = "center",
                             overlay_threshold: float = 0.5) -> torch.Tensor:
    """The locality rule for one target per sample, include_self=True
    (caption_module.py:322-363).  corners (B, K, 8, 3), object_masks (B, K),
    target_ids (B,) -> (B, K) float 0/1 local masks.  The ``num_locals``
    selected ids of a row are distinct (they come from a sort), so the
    scatter below never writes one slot twice."""
    B, K = object_masks.shape
    corners = corners.detach()
    tid = target_ids.long()
    rows = torch.arange(B, device=corners.device)
    centers = bbox_centers(corners)                              # (B,K,3)
    t_centers = centers[rows, tid][:, None]                      # (B,1,3)
    t_corners = corners[rows, tid][:, None]                      # (B,1,8,3)
    if query_mode == "center":
        dist = norm3(t_centers - centers)
    elif query_mode == "corner":
        dist = norm3(t_corners[:, 0, :, None, :]
                     - centers[:, None, :, :]).amin(dim=1)
    else:
        raise ValueError(f"invalid query_mode {query_mode}")
    iou = box3d_iou_batch(t_corners.expand_as(corners), corners)
    self_mask = torch.arange(K, device=corners.device)[None] == tid[:, None]
    topk = mask_and_topk_locals(dist, object_masks == 0, iou, self_mask,
                                num_locals, overlay_threshold)
    masks = torch.zeros((B, K), dtype=torch.float32, device=corners.device)
    return masks.scatter_(1, topk, 1.0)


def add_relation_feat(data_dict: dict, obj_feats: torch.Tensor,
                      target_ids: torch.Tensor) -> torch.Tensor:
    """Scatter the target's edge features onto its neighbour proposals and
    add (caption_module.py:394-414).  obj_feats (B, K, C), target_ids (B,).
    A row of ``edge_nbr_idx`` holds distinct ids, so no slot is written
    twice."""
    B, K, C = obj_feats.shape
    rows = torch.arange(B, device=obj_feats.device)
    tid = target_ids.long()
    rel_feats = data_dict["edge_feature"][rows, tid]             # (B, L, C)
    nbr = data_dict["edge_nbr_idx"][rows, tid].long()            # (B, L)
    scattered = torch.zeros_like(obj_feats).scatter(
        1, nbr[..., None].expand(-1, -1, C), rel_feats)
    return obj_feats + scattered


def _gather_targets(x: torch.Tensor, target_ids: torch.Tensor) -> torch.Tensor:
    """x (B, K, C), ids (B,) -> (B, C)."""
    return x[torch.arange(x.shape[0], device=x.device), target_ids.long()]


def _mask_pad_logits(logits: torch.Tensor, num_vocabs: int) -> torch.Tensor:
    """Classifier columns past the real vocabulary -> -1e30, so argmax
    never picks a pad id and softmax gives them exactly 0."""
    if logits.shape[-1] == num_vocabs:
        return logits
    logits = logits.clone()
    logits[..., num_vocabs:] = -1e30
    return logits


def _gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, C), idx (B, K, L) -> (B, K, L, C)."""
    B, K, L = idx.shape
    flat = idx.reshape(B, K * L).long()
    return torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1])
                        ).reshape(B, K, L, -1)


class TopDownSceneCaptionModule(nn.Module):
    """2-layer attention decoder (caption_module.py:202-592)."""

    def __init__(self, num_vocabs: int, emb_size: int = 300,
                 feat_size: int = 128, hidden_size: int = 512,
                 num_locals: int = -1, query_mode: str = "center",
                 use_relation: bool = False, max_des_len: int = 30,
                 min_iou: float = 0.25, overlay_threshold: float = 0.5,
                 num_vocabs_padded: int = 0):
        super().__init__()
        if num_vocabs_padded and num_vocabs_padded < num_vocabs:
            raise ValueError(f"num_vocabs_padded={num_vocabs_padded} < "
                             f"num_vocabs={num_vocabs}")
        self.num_vocabs = num_vocabs
        self.hidden_size = hidden_size
        self.num_locals = num_locals
        self.query_mode = query_mode
        self.use_relation = use_relation
        self.max_des_len = max_des_len
        self.min_iou = min_iou
        self.overlay_threshold = overlay_threshold
        H = hidden_size
        self.map_topdown = nn.Linear(emb_size + H + feat_size, emb_size)
        self.recurrent_cell_1 = GRUCell(emb_size, H)
        self.map_feat = nn.Linear(feat_size, H, bias=False)
        self.map_hidd = nn.Linear(H, H, bias=False)
        self.attend = nn.Linear(H, 1, bias=False)
        self.map_lang = nn.Linear(feat_size + H, emb_size)
        self.recurrent_cell_2 = GRUCell(emb_size, H)
        self.classifier = nn.Linear(H, num_vocabs_padded or num_vocabs)

    def forward(self, data_dict: dict, use_tf: bool = True,
                is_eval: bool = False) -> dict:
        if not is_eval:
            return self.forward_sample_batch(data_dict)
        return self.forward_scene_batch(data_dict)

    def _decode(self, target_feat: torch.Tensor, obj_feats: torch.Tensor,
                mapped_obj: torch.Tensor, valid_masks: torch.Tensor,
                word_embs: torch.Tensor, num_steps: int):
        """Teacher-forced decode of one target per row.

        target_feat (N, C), obj_feats (N, K, C), mapped_obj (N, K, H) =
        map_feat(obj_feats), valid_masks (N, K), word_embs (N, T, emb) ->
        logits (N, num_steps, V), attn (N, K, num_steps)."""
        N = target_feat.shape[0]
        h1 = target_feat.new_zeros((N, self.hidden_size))
        h2 = target_feat.new_zeros((N, self.hidden_size))
        neg_mask = torch.where(valid_masks[..., None] == 0, -1e30, 0.0)
        logits_t, attn_t = [], []
        for t in range(num_steps):
            x = torch.cat([word_embs[:, t], h2, target_feat], dim=-1)
            x = torch.relu(self.map_topdown(x))
            h1 = self.recurrent_cell_1(x, h1)
            combined = torch.tanh(mapped_obj + self.map_hidd(h1)[:, None, :])
            scores = self.attend(combined) + neg_mask            # (N, K, 1)
            attn = torch.softmax(scores, dim=1)
            attended = torch.sum(obj_feats * attn, dim=1)        # (N, C)
            lang_in = torch.relu(self.map_lang(
                torch.cat([attended, h1], dim=-1)))
            h2 = self.recurrent_cell_2(lang_in, h2)
            logits_t.append(_mask_pad_logits(self.classifier(h2),
                                             self.num_vocabs))
            attn_t.append(attn[..., 0])
        return torch.stack(logits_t, dim=1), torch.stack(attn_t, dim=2)

    def forward_sample_batch(self, data_dict: dict) -> dict:
        d = dict(data_dict)
        word_embs = d["lang_feat"]                               # (B,T,emb)
        obj_feats = d["bbox_feature"]                            # (B,K,C)
        object_masks = d["bbox_mask"].to(torch.float32)
        target_ids, target_ious = select_target(d)
        target_feats = _gather_targets(obj_feats, target_ids)
        if self.num_locals == -1:
            valid_masks = object_masks
        else:
            valid_masks = query_locals_for_targets(
                d["bbox_corner"], object_masks, target_ids, self.num_locals,
                self.query_mode, self.overlay_threshold)
        if self.use_relation:
            obj_feats = add_relation_feat(d, obj_feats, target_ids)
        mapped_obj = self.map_feat(obj_feats)
        logits, attns = self._decode(target_feats, obj_feats, mapped_obj,
                                     valid_masks, word_embs,
                                     self.max_des_len + 1)
        good = target_ious > self.min_iou
        num_good = torch.sum(good)
        mean_iou = torch.where(
            num_good > 0,
            torch.sum(target_ious * good) / torch.clamp(num_good, min=1),
            torch.zeros_like(target_ious[0]))
        d["lang_cap"] = logits                                   # (B,T-1,V)
        d["pred_ious"] = mean_iou
        d["topdown_attn"] = attns
        d["valid_masks"] = valid_masks
        d["good_bbox_masks"] = good
        return d

    def _decode_scene_local(self, tgt: torch.Tensor, base_loc: torch.Tensor,
                            ctx_loc: torch.Tensor, first_input: torch.Tensor,
                            emb_table: torch.Tensor, num_steps: int):
        """tgt (B, K, C), base_loc (B, K, L, H) attention base per slot,
        ctx_loc (B, K, L, C) context per slot, first_input (B, K, emb) ->
        tokens (B, K, T), attn (B, K, T, L)."""
        B, K, _ = tgt.shape
        w = self.attend.weight[0]                                   # (H,)
        h1 = tgt.new_zeros((B, K, self.hidden_size))
        h2 = tgt.new_zeros((B, K, self.hidden_size))
        prev = first_input
        tokens_t, attn_t = [], []
        for _ in range(num_steps):
            x = torch.relu(self.map_topdown(torch.cat([prev, h2, tgt], -1)))
            h1 = self.recurrent_cell_1(x, h1)
            hproj = self.map_hidd(h1)
            scores = torch.sum(torch.tanh(base_loc + hproj[:, :, None]) * w,
                               dim=-1)                              # (B,K,L)
            attn = torch.softmax(scores, dim=-1)
            attended = torch.einsum("btl,btlc->btc", attn, ctx_loc)
            lang_in = torch.relu(self.map_lang(torch.cat([attended, h1], -1)))
            h2 = self.recurrent_cell_2(lang_in, h2)
            logits = _mask_pad_logits(self.classifier(h2), self.num_vocabs)
            tokens = torch.argmax(logits, dim=-1)                   # (B,K)
            prev = emb_table[tokens]
            tokens_t.append(tokens)
            attn_t.append(attn)
        return (torch.stack(tokens_t, dim=2).to(torch.int32),
                torch.stack(attn_t, dim=2))

    def forward_scene_batch(self, data_dict: dict) -> dict:
        if self.num_locals == -1:
            raise NotImplementedError(
                "the full-K scene decode (num_locals=-1) is not ported yet; "
                "the flagship decodes over num_locals slots")
        d = dict(data_dict)
        emb_table = d["glove_emb_table"]
        obj_feats = d["bbox_feature"]                               # (B,K,C)
        object_masks = d["bbox_mask"].to(torch.float32)
        B, K, _ = obj_feats.shape
        sos = d["lang_feat"][:, 0]
        all_valid, loc_idx = query_locals_dense(
            d["bbox_corner"], object_masks, self.num_locals, self.query_mode,
            include_self=True, overlay_threshold=self.overlay_threshold)
        shared_mapped = self.map_feat(obj_feats)                    # (B,K,H)
        sh_loc = _gather_slots(shared_mapped, loc_idx)              # (B,K,L,H)
        obj_loc = _gather_slots(obj_feats, loc_idx)                 # (B,K,L,C)
        if self.use_relation:
            # map_feat is linear without bias: map_feat(obj + scatter(rel))
            # == shared + scatter(map_feat(rel)); only neighbour slots move
            rel_all = d["edge_feature"]                             # (B,K,Le,C)
            nbr_all = d["edge_nbr_idx"]                             # (B,K,Le)
            delta = self.map_feat(rel_all)
            match = (loc_idx[:, :, :, None].long()
                     == nbr_all[:, :, None, :].long()).to(obj_feats.dtype)
            sh_loc = sh_loc + torch.einsum("btlj,btjh->btlh", match, delta)
            obj_loc = obj_loc + torch.einsum("btlj,btjc->btlc", match, rel_all)
        d["lang_cap"], d["topdown_attn"] = self._decode_scene_local(
            obj_feats, sh_loc, obj_loc,
            sos[:, None].expand(B, K, sos.shape[-1]), emb_table,
            self.max_des_len - 1)                                   # 29 steps
        d["topdown_attn_slots"] = loc_idx                           # (B,K,L)
        d["valid_masks"] = all_valid
        return d
