"""What each rank runs in the port's mesh tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_spatial.py``).

The ranks are spawned processes (``scan2cap_torch.parallel.mesh.launch``
with gloo on the CPU, one torch thread each), so this module imports torch
and the port only: the JAX references are computed in the test process.
Each function runs on every rank and returns what rank 0 hands back.
"""

from __future__ import annotations

import copy
import os

import torch
import torch.distributed as dist

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.data import synthetic
from scan2cap_torch.losses.total import get_scene_cap_loss
from scan2cap_torch.models import CapNet
from scan2cap_torch.parallel import mesh as pmesh
from scan2cap_torch.train.checkpoints import resume_bundle, restore_resume
from scan2cap_torch.train.step import (create_train_state, make_eval_step,
                                       make_train_step)

LOSSES = dict(detection=True, caption=True, orientation=True, distance=True)


def _model(cfg_kw, V, VP, sd, shard=True):
    cfg = ModelConfig(**cfg_kw)
    model = CapNet(cfg, num_vocabs=V, num_vocabs_padded=VP, device="cpu")
    model.load_state_dict(sd, strict=True)
    if shard:
        pmesh.shard_model(model)
    return cfg, model


def _all(obj):
    """Every rank's ``obj``, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _loss_and_grads(cfg, model, batch):
    """This rank's share of the train-mode loss, backpropagated; the
    gradients summed over the data group and gathered whole."""
    model.train()
    out = model(pmesh.local_rows(batch), use_tf=True, is_eval=False,
                train=True, bn_momentum=0.1)
    out = get_scene_cap_loss(out, num_bins=cfg.num_bins,
                             num_heading_bin=cfg.num_heading_bin,
                             num_size_cluster=cfg.num_size_cluster, **LOSSES)
    out["loss"].backward()
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    pmesh.sum_gradients(params)
    dims = model.shard_dims
    grads = {n: (pmesh.all_gather(p.grad, "model", dims[n]) if n in dims
                 else p.grad.clone()) for n, p in model.named_parameters()}
    return float(pmesh.sum_metrics({"l": out["loss"].detach()})["l"]), grads


def _steps(cfg, model, batch, n, state=None):
    state = state or create_train_state(cfg, model)
    step = make_train_step(cfg, state, **LOSSES)
    local = pmesh.local_rows(batch)
    return state, [{k: float(v) for k, v in step(local, 1e-3, 0.1).items()}
                   for _ in range(n)]


def capnet_2x2(cfg_kw, V, VP, sd, batch, workdir, plain):
    """At (2, 2): eval tokens, the loss and its gradients, the classifier's
    shard shapes, four steps with a save after step 2, and steps 3-4 again
    from the restored save; then the plain GRU decoder of ``plain`` (its
    config, vocabulary and batch): eval tokens, loss and gradients."""
    tb = synthetic.to_device(batch, "cpu")
    res = {"plain": plain_decoder(*plain)}
    cfg, model = _model(cfg_kw, V, VP, sd)
    res["shard_shapes"] = _all(
        tuple(model.caption.classifier.weight.shape))
    eval_step = pmesh.mesh_eval_fn(make_eval_step(cfg, model))
    res["tokens"] = eval_step(tb)["lang_cap"].numpy()
    res["loss"], res["grads"] = _loss_and_grads(cfg, model, tb)

    cfg, model = _model(cfg_kw, V, VP, sd)
    state, m12 = _steps(cfg, model, tb, 2)
    bundle = resume_bundle(0, model, state.optimizer, state.step)
    if pmesh.is_main():
        torch.save(bundle, os.path.join(workdir, "resume_2x2.pt"))
    _, m34 = _steps(cfg, model, tb, 2, state)
    res["metrics"] = m12 + m34
    res["after"] = resume_bundle(1, model, state.optimizer, state.step)

    dist.barrier()
    cfg, model = _model(cfg_kw, V, VP, {k: torch.zeros_like(v)
                                        for k, v in sd.items()})
    state = create_train_state(cfg, model)
    restore_resume(state, torch.load(os.path.join(workdir, "resume_2x2.pt"),
                                     weights_only=True))
    _, m34_again = _steps(cfg, model, tb, 2, state)
    res["metrics_again"] = m34_again
    res["after_again"] = resume_bundle(1, model, state.optimizer, state.step)
    return res


def plain_decoder(cfg_kw, V, batch):
    """The GRU decoder's split: ``map_feat`` over its output (with its
    bias), an odd vocabulary's classifier over its hidden rows."""
    cfg = ModelConfig(**cfg_kw)
    model = CapNet(cfg, num_vocabs=V, device="cpu", seed=3)
    pmesh.shard_model(model)
    tb = synthetic.to_device(batch, "cpu")
    eval_step = pmesh.mesh_eval_fn(make_eval_step(cfg, model))
    res = {"tp": dict(model.caption.tp),
           "tokens": eval_step(tb)["lang_cap"].numpy()}
    res["loss"], res["grads"] = _loss_and_grads(cfg, model, tb)
    return res


def restore_elsewhere(cfg_kw, V, VP, path):
    """Restore a whole resume bundle into this mesh shape, take one step,
    and hand back the bundle it saves before the step."""
    bundle = torch.load(path, weights_only=True)
    cfg, model = _model(cfg_kw, V, VP, {k: torch.zeros_like(v) for k, v in
                                        bundle["model"].items()})
    state = create_train_state(cfg, model)
    restore_resume(state, bundle)
    # a copy: on the CPU the bundle's tensors are the live ones
    back = copy.deepcopy(resume_bundle(0, model, state.optimizer,
                                       state.step))
    batch = synthetic.make_scene_batch(
        ModelConfig(**cfg_kw), batch_size=4, num_objects=3,
        vocab=synthetic.make_vocab(num_vocabs=V), seed=0)
    _, metrics = _steps(cfg, model, synthetic.to_device(batch, "cpu"), 1)
    return {"bundle": back, "loss": metrics[0]["loss"]}


def data_4x1(cfg_kw, V, VP, sd, batch, bn_input, loss_cases):
    """At (4, 1): eval tokens, a SharedMLP's train-mode output, running
    statistics and gradients, and every loss of ``loss_cases`` as the sum
    of the ranks' shares."""
    from scan2cap_torch.losses.mask_votenet import get_mask_votenet_loss
    from scan2cap_torch.losses.pretrained import get_pretrained_loss
    from scan2cap_torch.losses.total import get_object_cap_loss
    from scan2cap_torch.models.layers import SharedMLP, seeded_init

    res = {}
    cfg, model = _model(cfg_kw, V, VP, sd)
    eval_step = pmesh.mesh_eval_fn(make_eval_step(cfg, model))
    res["tokens"] = eval_step(synthetic.to_device(batch, "cpu"))[
        "lang_cap"].numpy()

    mlp = SharedMLP(bn_input.shape[-1], (32, 32))
    seeded_init(mlp, 3)
    x = pmesh.local_rows({"x": bn_input})["x"]
    y = mlp(x, train=True, bn_momentum=0.1)
    w = torch.linspace(-1.0, 1.0, y.shape[-1])
    (torch.sum(y * w) / pmesh.batch_count(y.numel())).backward()
    pmesh.sum_gradients(list(mlp.parameters()))
    grads = {n: p.grad for n, p in mlp.named_parameters()}
    res["bn"] = {"y": pmesh.all_gather(y.detach(), "data", 0),
                 "stats": {k: v.clone() for k, v in mlp.state_dict().items()
                           if "running_" in k},
                 "grads": {k: v.clone() for k, v in grads.items()}}

    fns = {"scene": lambda d: get_scene_cap_loss(
               d, num_bins=cfg.num_bins, num_heading_bin=cfg.num_heading_bin,
               num_size_cluster=cfg.num_size_cluster, **LOSSES),
           "mask_votenet": get_mask_votenet_loss,
           "pretrained_gt": lambda d: get_pretrained_loss(d, mode="gt"),
           "pretrained_votenet": lambda d: get_pretrained_loss(
               d, mode="votenet", distance=True),
           "object": lambda d: get_object_cap_loss(d)}
    res["losses"] = {}
    for name, (fn_name, data, keys) in loss_cases.items():
        out = fns[fn_name](pmesh.local_rows(data))
        res["losses"][name] = {k: float(v) for k, v in pmesh.sum_metrics(
            {k: out[k].detach() for k in keys}).items()}
    return res


def _by_shape(eval_step):
    """``mesh_eval_fn`` as it gathered before its outputs were named: every
    tensor whose leading axis is a rank's scene count."""
    def wrapped(batch):
        mesh = pmesh.current()
        n = batch["point_clouds"].shape[0]
        per = -(-n // mesh.n_data)
        local = {k: v if k in pmesh.REPLICATED_KEYS or v.dim() == 0 else
                 v.index_select(0, pmesh._rows(n, mesh.n_data, mesh.d,
                                               v.device))
                 for k, v in batch.items()}
        return {k: (pmesh.all_gather(v, "data", 0)[:n]
                    if torch.is_tensor(v) and v.dim() > 0
                    and v.shape[0] == per else v)
                for k, v in eval_step(local).items()}
    return wrapped


def eval_outputs_2x1(cfg_kw, V, VP, sd, batch):
    """At (2, 1) on an odd batch: every output of ``make_eval_step``
    through ``mesh_eval_fn`` and through the gather by shape it replaced;
    an output declared replicated comes back as the rank's own; an
    undeclared output of a rank's scene count raises on every rank."""
    tb = synthetic.to_device(batch, "cpu")
    cfg, model = _model(cfg_kw, V, VP, sd)
    step = make_eval_step(cfg, model)
    res = {"named": {k: v.numpy() for k, v in
                     pmesh.mesh_eval_fn(step)(tb).items()},
           "by_shape": {k: v.numpy() for k, v in
                        _by_shape(step)(tb).items()}}

    def toy(b):
        per = b["point_clouds"].shape[0]
        return {"scene_sum": b["point_clouds"].sum((1, 2)),
                "table": torch.full((per, 2), 7.0),
                "count": torch.tensor(per)}

    toy.per_scene_outputs = ("scene_sum",)
    toy.replicated_outputs = ("table",)
    res["toy"] = {k: v.numpy() for k, v in
                  pmesh.mesh_eval_fn(toy)(tb).items()}
    del toy.replicated_outputs
    try:
        pmesh.mesh_eval_fn(toy)(tb)
        res["undeclared"] = None
    except ValueError as e:
        res["undeclared"] = _all(str(e))
    return res


def spatial_ops(xyz, new_xyz, feats, radius, nsample, axis):
    """The sharded ball query and query-and-group over ``axis``, and the
    collectives each axis issued."""
    from scan2cap_torch.parallel import spatial

    pmesh.COLLECTIVES.clear()
    idx = spatial.ball_query_sharded(xyz, new_xyz, radius, nsample, axis)
    counts_bq = dict(pmesh.COLLECTIVES)
    grouped = spatial.query_and_group_sharded(
        xyz, new_xyz, feats, radius, nsample, axis, use_xyz=True,
        normalize_xyz=True)
    return {"idx": idx, "grouped": grouped, "bq_collectives": counts_bq,
            "ranks": _all(dict(pmesh.COLLECTIVES))}


def spatial_backbone(sa_npoints, pc, sd):
    """The backbone with ``spatial_axis="model"``: this data shard's eval
    outputs, and the train-mode loss sum(fp2^2) * 1e-3 with its gradients
    summed over the data group, gathered whole on rank 0."""
    from scan2cap_torch.models.backbone import Pointnet2Backbone

    def build(axis):
        net = Pointnet2Backbone(pc.shape[-1] - 3, tuple(sa_npoints),
                                spatial_axis=axis)
        net.load_state_dict(sd, strict=True)
        return net

    net = build("model")
    local = pmesh.local_rows({"point_clouds": pc})
    with torch.no_grad():
        out = net(local, train=False)
    keys = ("sa1_inds", "sa2_inds", "fp2_inds", "sa1_features",
            "sa4_features", "fp2_features")
    res = {"eval": {k: pmesh.all_gather(out[k], "data", 0) for k in keys}}
    out = net(local, train=True, bn_momentum=0.1)
    loss = torch.sum(out["fp2_features"] ** 2) * 1e-3
    loss.backward()
    params = list(net.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    pmesh.sum_gradients(params)
    res["loss"] = float(pmesh.sum_metrics({"l": loss.detach()})["l"])
    res["grads"] = {n: p.grad.clone() for n, p in net.named_parameters()}
    # after the sums every rank holds the same gradients
    res["grad_sums"] = _all(sum(float(p.grad.double().sum())
                                for p in params))
    return res


def elision_and_bytes(cfg_kw, V, sd, batch):
    """At (4, 1): one train step with the size-one elision (the model axis
    has one rank) and the same step with it turned off (``_alone``
    patched to answer False): each one's loss, gradients and calls by
    axis.  Then, over sub-meshes of the same four ranks, the bytes of
    collectives of known sizes at (2, 2), and at (4, 1) a model-axis
    all-reduce, which is not issued."""
    from scan2cap_torch.parallel.mesh import MeshSpec

    res = {}
    tb = synthetic.to_device(batch, "cpu")
    alone = pmesh._alone
    for elide in (True, False):
        if not elide:
            pmesh._alone = lambda mesh, axis: False
        try:
            cfg, model = _model(cfg_kw, V, 0, sd)
            pmesh.COLLECTIVES.clear()
            state, metrics = _steps(cfg, model, tb, 1)
            res[elide] = dict(
                loss=metrics[0]["loss"], calls=dict(pmesh.COLLECTIVES),
                grads={n: p.grad.clone()
                       for n, p in model.named_parameters()})
        finally:
            pmesh._alone = alone

    x = torch.arange(15, dtype=torch.float32).reshape(3, 5)
    with pmesh.using(pmesh.sub_mesh(MeshSpec(2, 2))):
        pmesh.COLLECTIVES.clear()
        pmesh.COLLECTIVE_BYTES.clear()
        pmesh.all_reduce(x, "data")
        pmesh.all_reduce(x, "model", dist.ReduceOp.MAX)
        pmesh.all_gather(torch.zeros((2, 3), dtype=torch.int32), "model", 1)
        pmesh.all_gather(torch.ones(4, dtype=torch.bool), "data", 0)
        pmesh.gather(torch.zeros((2, 7), dtype=torch.float64), "model", -1)
        res["bytes"] = (dict(pmesh.COLLECTIVES),
                        dict(pmesh.COLLECTIVE_BYTES))
    with pmesh.using(pmesh.sub_mesh(MeshSpec(4, 1))):
        pmesh.COLLECTIVES.clear()
        pmesh.COLLECTIVE_BYTES.clear()
        y = pmesh.all_reduce(x, "model")
        res["size_one"] = (dict(pmesh.COLLECTIVES),
                           dict(pmesh.COLLECTIVE_BYTES), y)
    return res
