"""Caption decoders
(counterpart of ``scan2cap_tpu/models/caption.py``; reference
models/caption_module.py:16-592).

``SceneCaptionModule`` is the plain GRU decoder (caption_module.py:40-200):
the target proposal's projected feature is the GRU's first hidden state.
``TopDownSceneCaptionModule`` is the 2-layer attention decoder
(caption_module.py:202-592).

``forward_sample_batch`` is the training path of both: one target proposal
per sample (the argmax-IoU proposal against the GT reference box, or with
the top-down decoder's ``use_oracle`` the batch's ``bbox_idx``), decoded
teacher-forced for ``max_des_len + 1`` steps; the top-down decoder attends
over all K proposals, masked to the target's ``num_locals`` locals.

``forward_scene_batch`` decodes a caption for every proposal, free-running
from the sos embedding, for ``max_des_len - 1`` steps.  The top-down
decoder attends either over each target's ``num_locals`` local slots
(``_local_reader``): every other proposal is -1e30-masked in the
reference, so its softmax weight is exactly 0 and scoring only the local
slots is the same math; or, with ``num_locals=-1``, over all K proposals
(``_full_reader``), targets taken ``eval_chunk`` at a time.

The top-down decoder has one step (``_step``) and one loop
(``_decode_loop``) for all three decodes; only the attention reader
differs.  ``_decode`` runs the loop, or replays it from
``models/decode_graph``: teacher-forced, with grad enabled, as two CUDA
graphs, forward and backward; free-running, with grad off, as one forward
graph.  Either runs eager on a CPU, under a mesh or under a tracer.

Under a mesh (``parallel.mesh``) the model axis splits the classifier
(its vocabulary columns, or its hidden rows where the width does not
divide) and the hidden axis of ``map_feat`` and ``map_hidd``
(``parallel.mesh.shard_model`` sets ``tp``): in training the logits are
gathered before the log-softmax and the argmax, and the attention
score's partial sums are summed over the model group.  The eval decode
gathers those weights whole once per forward and splits its targets over
the model group instead (``parallel.mesh.decode_split``, the JAX
package's ``_shard_targets``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scan2cap_torch.models.decode_graph import (DecodeGraphs,
                                                SceneDecodeGraphs)
from scan2cap_torch.models.graph import (bbox_centers, mask_and_topk_locals,
                                         norm3, query_locals_dense)
from scan2cap_torch.models.layers import GRUCell
from scan2cap_torch.ops.boxes import box3d_iou_batch
from scan2cap_torch.parallel import mesh as pmesh
from scan2cap_torch.utils.profiling import annotate


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


def _iou_gate(target_ious: torch.Tensor, min_iou: float):
    """(good_bbox_masks (B,) bool, pred_ious: the mean IoU of the good
    targets, 0 without one; under a mesh this rank's share of the global
    mean)."""
    good = target_ious > min_iou
    num_good = pmesh.batch_sum(torch.sum(good))
    mean_iou = torch.where(
        num_good > 0,
        torch.sum(target_ious * good) / torch.clamp(num_good, min=1),
        torch.zeros_like(target_ious[0]))
    return good, mean_iou


class _SplitLinears(nn.Module):
    """The caption linears as ``tp`` splits them over the model axis
    (linear name -> the split dim of its torch weight; empty without a
    mesh).  ``_full`` holds whole weights during an eval decode."""

    tp: dict = {}
    _full = None

    def _lin(self, name: str, x: torch.Tensor,
             local: bool = False) -> torch.Tensor:
        """Linear ``name`` on ``x``.  Split along its output, the result
        is gathered (or, with ``local``, this rank's columns are
        returned); split along its input, the partial products are
        summed over the model group."""
        lin = getattr(self, name)
        if self._full is not None and name in self._full:
            return F.linear(x, *self._full[name])
        dim = self.tp.get(name)
        if dim is None:
            return lin(x)
        if dim == 0:
            bias = (None if lin.bias is None else
                    pmesh.shard_of(pmesh.enter(lin.bias), "model", 0))
            y = F.linear(pmesh.enter(x), lin.weight, bias)
            return y if local else pmesh.gather(y, "model", -1)
        xs = pmesh.shard_of(pmesh.enter(x), "model", -1)
        y = pmesh.psum(F.linear(xs, lin.weight))
        return y if lin.bias is None else y + lin.bias

    def _attend(self, combined: torch.Tensor) -> torch.Tensor:
        """attend(combined) where ``combined`` may hold this rank's hidden
        columns only (``map_hidd`` split): the partial scores are summed
        over the model group."""
        if self._full is None and self.tp.get("map_hidd") == 0:
            w = pmesh.shard_of(pmesh.enter(self.attend.weight), "model", 1)
            return pmesh.psum(F.linear(combined, w))
        return self.attend(combined)

    @contextlib.contextmanager
    def _whole_weights(self):
        """Under a split: the split weights gathered whole, for an eval
        decode that splits its targets instead."""
        if not self.tp:
            yield
            return
        full = {}
        for name, dim in self.tp.items():
            lin = getattr(self, name)
            full[name] = (pmesh.all_gather(lin.weight, "model", dim),
                          lin.bias)
        self._full = full
        try:
            yield
        finally:
            self._full = None


class SceneCaptionModule(_SplitLinears):
    """Plain GRU decoder (caption_module.py:40-200): ``map_feat`` + ReLU
    projects the proposal features to the embedding width, which is also
    the GRU's hidden width; the classifier reads the hidden state."""

    def __init__(self, num_vocabs: int, emb_size: int = 300,
                 feat_size: int = 128, max_des_len: int = 30,
                 min_iou: float = 0.25, eval_chunk: int = 32,
                 num_vocabs_padded: int = 0):
        super().__init__()
        if num_vocabs_padded and num_vocabs_padded < num_vocabs:
            raise ValueError(f"num_vocabs_padded={num_vocabs_padded} < "
                             f"num_vocabs={num_vocabs}")
        self.num_vocabs = num_vocabs
        self.max_des_len = max_des_len
        self.min_iou = min_iou
        self.eval_chunk = eval_chunk
        self.map_feat = nn.Linear(feat_size, emb_size)
        self.recurrent_cell = GRUCell(emb_size, emb_size)
        self.classifier = nn.Linear(emb_size, num_vocabs_padded or num_vocabs)

    def forward(self, data_dict: dict, use_tf: bool = True,
                is_eval: bool = False) -> dict:
        if not is_eval:
            return self.forward_sample_batch(data_dict)
        return self.forward_scene_batch(data_dict)

    def _decode(self, hidden: torch.Tensor, first_input: torch.Tensor,
                word_embs, emb_table, num_steps: int) -> torch.Tensor:
        """hidden (N, E) first hidden state, first_input (N, E).  Teacher
        forcing (``word_embs`` (N, T, E)) returns logits (N, num_steps, V);
        free running (``emb_table`` (V, E)) token ids (N, num_steps)."""
        prev, outs = first_input, []
        with annotate("scan2cap.decode"):
            for t in range(num_steps):
                hidden = self.recurrent_cell(prev, hidden)
                logits = _mask_pad_logits(self._lin("classifier", hidden),
                                          self.num_vocabs)
                if word_embs is not None:
                    prev = word_embs[:, t + 1]
                    outs.append(logits)
                else:
                    tokens = torch.argmax(logits, dim=-1)
                    prev = emb_table[tokens]
                    outs.append(tokens)
        return torch.stack(outs, dim=1)

    def forward_sample_batch(self, data_dict: dict) -> dict:
        d = dict(data_dict)
        word_embs = d["lang_feat"]                               # (B,T,E)
        obj_feats = torch.relu(self._lin("map_feat", d["bbox_feature"]))
        target_ids, target_ious = select_target(d)
        logits = self._decode(_gather_targets(obj_feats, target_ids),
                              word_embs[:, 0], word_embs, None,
                              self.max_des_len + 1)
        good, mean_iou = _iou_gate(target_ious, self.min_iou)
        d["lang_cap"] = logits                                   # (B,T-1,V)
        d["pred_ious"] = mean_iou
        d["good_bbox_masks"] = good
        return d

    def forward_scene_batch(self, data_dict: dict) -> dict:
        with self._whole_weights():
            return self._forward_scene(data_dict)

    def _forward_scene(self, data_dict: dict) -> dict:
        d = dict(data_dict)
        emb_table = d["glove_emb_table"]                         # (V, E)
        obj_feats = torch.relu(self._lin("map_feat", d["bbox_feature"]))
        B, K, E = obj_feats.shape                                # (B,K,E)
        sos = d["lang_feat"][:, 0]                               # (B, E)

        def decode(feats):
            kc = feats.shape[1]
            tokens = self._decode(
                feats.reshape(B * kc, E),
                sos[:, None].expand(B, kc, E).reshape(B * kc, E), None,
                emb_table, self.max_des_len - 1)                 # 29 steps
            return (tokens.reshape(B, kc, -1),)

        chunks = [pmesh.decode_split(
            decode, [obj_feats[:, s:s + self.eval_chunk]])[0]
            for s in range(0, K, self.eval_chunk)]
        d["lang_cap"] = torch.cat(chunks, dim=1).to(torch.int32)  # (B,K,T)
        return d


class TopDownSceneCaptionModule(_SplitLinears):
    """2-layer attention decoder (caption_module.py:202-592)."""

    # the modules the decode step reads
    DECODER = ("map_topdown", "recurrent_cell_1", "map_hidd", "attend",
               "map_lang", "recurrent_cell_2", "classifier")

    def __init__(self, num_vocabs: int, emb_size: int = 300,
                 feat_size: int = 128, hidden_size: int = 512,
                 num_locals: int = -1, query_mode: str = "center",
                 use_relation: bool = False, max_des_len: int = 30,
                 min_iou: float = 0.25, overlay_threshold: float = 0.5,
                 eval_chunk: int = 32, num_vocabs_padded: int = 0,
                 use_oracle: bool = False):
        super().__init__()
        if num_vocabs_padded and num_vocabs_padded < num_vocabs:
            raise ValueError(f"num_vocabs_padded={num_vocabs_padded} < "
                             f"num_vocabs={num_vocabs}")
        self.num_vocabs = num_vocabs
        # the pretrained track's GT boxes: the target is the batch's
        # bbox_idx, its IoU 1 (caption.py:349-351)
        self.use_oracle = use_oracle
        self.hidden_size = hidden_size
        self.num_locals = num_locals
        self.query_mode = query_mode
        self.use_relation = use_relation
        self.max_des_len = max_des_len
        self.min_iou = min_iou
        self.overlay_threshold = overlay_threshold
        self.eval_chunk = eval_chunk
        H = hidden_size
        self.map_topdown = nn.Linear(emb_size + H + feat_size, emb_size)
        self.recurrent_cell_1 = GRUCell(emb_size, H)
        self.map_feat = nn.Linear(feat_size, H, bias=False)
        self.map_hidd = nn.Linear(H, H, bias=False)
        self.attend = nn.Linear(H, 1, bias=False)
        self.map_lang = nn.Linear(feat_size + H, emb_size)
        self.recurrent_cell_2 = GRUCell(emb_size, H)
        self.classifier = nn.Linear(H, num_vocabs_padded or num_vocabs)
        self._decode_graphs = DecodeGraphs()
        self._scene_graphs = SceneDecodeGraphs()

    def forward(self, data_dict: dict, use_tf: bool = True,
                is_eval: bool = False) -> dict:
        if not is_eval:
            return self.forward_sample_batch(data_dict)
        return self.forward_scene_batch(data_dict)

    def _decode(self, reader, inputs: list, num_steps: int,
                teacher: bool = False):
        """``_decode_loop(reader, *inputs)``, or the replay of its CUDA
        graphs where ``models/decode_graph`` allows it.  A teacher-forced
        replay returns the graph's static buffers, which the next
        teacher-forced decode of the same shapes overwrites: a train step
        reads the logits in its loss and keeps neither output across
        steps.  A free-running replay returns tensors of their own."""
        graphs = self._decode_graphs if teacher else self._scene_graphs
        return graphs(
            functools.partial(self._decode_loop, reader, num_steps=num_steps,
                              teacher=teacher),
            inputs, self._decoder_params(),
            split=bool(self.tp) or pmesh.current() is not None,
            steps=num_steps)

    def _decoder_params(self) -> list:
        """The parameters the decode step reads in place."""
        return [p for name in self.DECODER
                for p in getattr(self, name).parameters()]

    def _decode_loop(self, reader, tgt: torch.Tensor, *inputs: torch.Tensor,
                     num_steps: int, teacher: bool = False):
        """One decode of the targets ``tgt`` (N, C) or (B, kc, C) from zero
        states, attending through ``reader(*context)``.  Teacher-forced,
        ``inputs`` are the context and the word embeddings (N, T, emb):
        step t reads word t.  Free-running, they are the context, the first
        input (B, kc, emb) and the embedding table (V, emb): a step reads
        the embedding of the previous step's argmax.  Returns logits
        (N, num_steps, V) and attn (N, K, num_steps), or int32 tokens
        (B, kc, num_steps) and attn (B, kc, num_steps, K or L)."""
        if teacher:
            *context, word_embs = inputs
            prev = word_embs[:, 0]
        else:
            *context, prev, emb_table = inputs
        h1 = tgt.new_zeros((*tgt.shape[:-1], self.hidden_size))
        h2 = tgt.new_zeros((*tgt.shape[:-1], self.hidden_size))
        read = reader(*context)
        outs, attns = [], []
        with annotate("scan2cap.decode"):
            for t in range(num_steps):
                h1, h2, logits, attn = self._step(prev, h1, h2, tgt, read)
                if teacher:
                    prev = word_embs[:, t + 1]
                    outs.append(logits)
                else:
                    tokens = torch.argmax(logits, dim=-1)
                    prev = emb_table[tokens]
                    outs.append(tokens)
                attns.append(attn)
        outs = torch.stack(outs, dim=tgt.dim() - 1)
        return (outs if teacher else outs.to(torch.int32),
                torch.stack(attns, dim=2))

    def _step(self, prev: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
              tgt: torch.Tensor, read):
        """One step: the input embedding ``prev``, the two GRU states and
        the target features -> the new states, the pad-masked logits and
        the attention that ``read(h1) -> (attended, attn)`` gives."""
        x = torch.relu(self.map_topdown(torch.cat([prev, h2, tgt], dim=-1)))
        h1 = self.recurrent_cell_1(x, h1)
        attended, attn = read(h1)
        lang_in = torch.relu(self.map_lang(torch.cat([attended, h1], dim=-1)))
        h2 = self.recurrent_cell_2(lang_in, h2)
        logits = _mask_pad_logits(self._lin("classifier", h2), self.num_vocabs)
        return h1, h2, logits, attn

    def _teacher_reader(self, obj_feats: torch.Tensor,
                        mapped_obj: torch.Tensor, valid_masks: torch.Tensor):
        """The teacher-forced attention of one target per row over all K
        proposals: obj_feats (N, K, C), mapped_obj (N, K, H) =
        map_feat(obj_feats), valid_masks (N, K).  Scored through the
        ``attend`` GEMM, -1e30 where not valid; attn (N, K)."""
        neg_mask = torch.where(valid_masks[..., None] == 0, -1e30, 0.0)

        def read(h1):
            combined = torch.tanh(
                mapped_obj + self._lin("map_hidd", h1, local=True)[:, None, :])
            attn = torch.softmax(self._attend(combined) + neg_mask,
                                 dim=1)                          # (N, K, 1)
            return torch.sum(obj_feats * attn, dim=1), attn[..., 0]
        return read

    def _full_reader(self, shared_mapped: torch.Tensor,
                     obj_feats: torch.Tensor, valid: torch.Tensor,
                     onehot_nbr, nbr_base, rel):
        """The full-K attention of a chunk of kc targets
        (caption.py:385-460): shared_mapped (B, K, H) = map_feat(obj_feats)
        for all targets, obj_feats (B, K, C), valid (B, kc, K).  With
        relation features, onehot_nbr (B, kc, L, K) marks each target's L
        neighbours, nbr_base (B, kc, L, H) is their corrected projection
        shared_mapped[nbr] + map_feat(rel) and rel (B, kc, L, C) their edge
        features: map_feat is linear, so only the neighbour slots differ
        from the shared projection.  attn (B, kc, K)."""
        w = self.attend.weight[0]                                   # (H,)
        neg_mask = torch.where(valid == 0, -1e30, 0.0)              # (B,kc,K)
        covered = onehot_nbr.sum(dim=2) if onehot_nbr is not None else None

        def read(h1):
            hproj = self._lin("map_hidd", h1)
            scores = torch.sum(torch.tanh(shared_mapped[:, None]
                                          + hproj[:, :, None]) * w,
                               dim=-1)                              # (B,kc,K)
            if onehot_nbr is not None:
                s_nbr = torch.sum(torch.tanh(nbr_base + hproj[:, :, None]) * w,
                                  dim=-1)                           # (B,kc,L)
                corr = torch.einsum("btl,btlk->btk", s_nbr, onehot_nbr)
                scores = torch.where(covered > 0, corr, scores)
            attn = torch.softmax(scores + neg_mask, dim=-1)
            attended = torch.einsum("btk,bkc->btc", attn, obj_feats)
            if onehot_nbr is not None:
                attn_nbr = torch.einsum("btk,btlk->btl", attn, onehot_nbr)
                attended = attended + torch.sum(attn_nbr[..., None] * rel,
                                                dim=2)
            return attended, attn
        return read

    def _local_reader(self, base_loc: torch.Tensor, ctx_loc: torch.Tensor):
        """The attention of each target over its L local slots: base_loc
        (B, K, L, H) the attention base per slot, ctx_loc (B, K, L, C) the
        context per slot.  attn (B, K, L)."""
        w = self.attend.weight[0]                                   # (H,)

        def read(h1):
            scores = torch.sum(torch.tanh(
                base_loc + self._lin("map_hidd", h1)[:, :, None]) * w,
                dim=-1)                                             # (B,K,L)
            attn = torch.softmax(scores, dim=-1)
            return torch.einsum("btl,btlc->btc", attn, ctx_loc), attn
        return read

    def forward_sample_batch(self, data_dict: dict) -> dict:
        d = dict(data_dict)
        word_embs = d["lang_feat"]                               # (B,T,emb)
        obj_feats = d["bbox_feature"]                            # (B,K,C)
        object_masks = d["bbox_mask"].to(torch.float32)
        if self.use_oracle:
            target_ids = d["bbox_idx"].to(torch.int32)
            target_ious = torch.ones(target_ids.shape, dtype=torch.float32,
                                     device=target_ids.device)
        else:
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
        mapped_obj = self._lin("map_feat", obj_feats, local=True)
        logits, attns = self._decode(
            self._teacher_reader,
            [target_feats, obj_feats, mapped_obj, valid_masks, word_embs],
            self.max_des_len + 1, teacher=True)
        good, mean_iou = _iou_gate(target_ious, self.min_iou)
        d["lang_cap"] = logits                                   # (B,T-1,V)
        d["pred_ious"] = mean_iou
        d["topdown_attn"] = attns
        d["valid_masks"] = valid_masks
        d["good_bbox_masks"] = good
        return d

    def forward_scene_batch(self, data_dict: dict) -> dict:
        with self._whole_weights():
            if self.num_locals == -1:
                return self._forward_scene_full(data_dict)
            return self._forward_scene_local(data_dict)

    def _forward_scene_local(self, data_dict: dict) -> dict:
        d = dict(data_dict)
        emb_table = d["glove_emb_table"]
        obj_feats = d["bbox_feature"]                               # (B,K,C)
        object_masks = d["bbox_mask"].to(torch.float32)
        B, K, _ = obj_feats.shape
        sos = d["lang_feat"][:, 0]
        all_valid, loc_idx = query_locals_dense(
            d["bbox_corner"], object_masks, self.num_locals, self.query_mode,
            include_self=True, overlay_threshold=self.overlay_threshold)
        shared_mapped = self._lin("map_feat", obj_feats)            # (B,K,H)
        sh_loc = _gather_slots(shared_mapped, loc_idx)              # (B,K,L,H)
        obj_loc = _gather_slots(obj_feats, loc_idx)                 # (B,K,L,C)
        if self.use_relation:
            # map_feat is linear without bias: map_feat(obj + scatter(rel))
            # == shared + scatter(map_feat(rel)); only neighbour slots move
            rel_all = d["edge_feature"]                             # (B,K,Le,C)
            nbr_all = d["edge_nbr_idx"]                             # (B,K,Le)
            delta = self._lin("map_feat", rel_all)
            match = (loc_idx[:, :, :, None].long()
                     == nbr_all[:, :, None, :].long()).to(obj_feats.dtype)
            sh_loc = sh_loc + torch.einsum("btlj,btjh->btlh", match, delta)
            obj_loc = obj_loc + torch.einsum("btlj,btjc->btlc", match, rel_all)
        d["lang_cap"], d["topdown_attn"] = pmesh.decode_split(
            lambda tgt, base, ctx, first: self._decode(
                self._local_reader, [tgt, base, ctx, first, emb_table],
                self.max_des_len - 1),
            [obj_feats, sh_loc, obj_loc,
             sos[:, None].expand(B, K, sos.shape[-1])])             # 29 steps
        d["topdown_attn_slots"] = loc_idx                           # (B,K,L)
        d["valid_masks"] = all_valid
        return d

    def _forward_scene_full(self, data_dict: dict) -> dict:
        """The num_locals=-1 scene decode (caption.py:533-534, 582-614):
        every target attends over all valid proposals."""
        d = dict(data_dict)
        emb_table = d["glove_emb_table"]
        obj_feats = d["bbox_feature"]                               # (B,K,C)
        B, K, _ = obj_feats.shape
        all_valid = d["bbox_mask"].to(torch.float32)[:, None, :].expand(B, K, K)
        sos = d["lang_feat"][:, 0]
        shared_mapped = self._lin("map_feat", obj_feats)            # (B,K,H)
        onehot = nbr_base = rel = None
        if self.use_relation:
            rel = d["edge_feature"]                                 # (B,K,L,C)
            nbr = d["edge_nbr_idx"]                                 # (B,K,L)
            nbr_base = (_gather_slots(shared_mapped, nbr)
                        + self._lin("map_feat", rel))
            onehot = nn.functional.one_hot(nbr.long(), K).to(obj_feats.dtype)
        tokens, attn = [], []
        for s in range(0, K, self.eval_chunk):
            sl = slice(s, s + self.eval_chunk)
            kc = obj_feats[:, sl].shape[1]
            tok, att = pmesh.decode_split(
                lambda tgt, valid, oh, nb, rl, first: self._decode(
                    self._full_reader,
                    [tgt, shared_mapped, obj_feats, valid, oh, nb, rl, first,
                     emb_table], self.max_des_len - 1),             # 29 steps
                [obj_feats[:, sl], all_valid[:, sl],
                 onehot[:, sl] if onehot is not None else None,
                 nbr_base[:, sl] if nbr_base is not None else None,
                 rel[:, sl] if rel is not None else None,
                 sos[:, None].expand(B, kc, sos.shape[-1])])
            tokens.append(tok)
            attn.append(att)
        d["lang_cap"] = torch.cat(tokens, dim=1)                    # (B,K,T)
        d["topdown_attn"] = torch.cat(attn, dim=1)                  # (B,K,T,K)
        d["valid_masks"] = all_valid
        return d
