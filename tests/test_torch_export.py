"""The serving export (``scan2cap_torch/scripts/export_model.py``) and the
three custom ops of ``scan2cap_torch/ops/library.py``, on the CPU.

* Each op (``scan2cap::furthest_point_sample``, ``scan2cap::ball_query``,
  ``scan2cap::group_points``) passes ``torch.library.opcheck`` (schema,
  fake tensor, autograd registration, AOT dispatch) and equals its plain
  version; ``group_points``' gradient is the scatter-add into the table.
* A run trained by the port's CLI at ``SCAN2CAP_TEST_TINY`` sizes (the
  CLI configuration's flags less multiview) is exported, saved, loaded
  and run: the loaded program's tokens, boxes and scores equal the eager
  ``Serve`` forward bitwise, in process and in a fresh process that
  imports only ``torch`` and ``scan2cap_torch.ops.library``; the program
  holds 5 FPS, 5 first-k and 6 gathers as the ops; the same weights in
  the JAX package's ``serve`` (``scripts/export_model.py:92-113``) give
  the same tokens and the floats within 1e-4 (the capnet tolerances);
  ``--load --check`` runs it on random input.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_cli import FLAGS, TINY, write_cli_data

from scan2cap_torch.ops import grouping, library, sampling
from scan2cap_torch.scripts import export_model
from scan2cap_torch.scripts import train as traincli

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
OUT_KEYS = ("tokens", "bbox_corner", "objectness_scores", "sem_cls_scores")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(seed, B=2, N=300):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(B, N, 3, generator=g) * 2.0 - 1.0


def test_fps_op(rng):
    xyz = _cloud(0)
    torch.library.opcheck(torch.ops.scan2cap.furthest_point_sample.default,
                          (xyz, 17))
    got = torch.ops.scan2cap.furthest_point_sample(xyz, 17)
    assert got.dtype == torch.int32 and got.shape == (2, 17)
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 17))
    assert torch.equal(sampling.furthest_point_sample(xyz, 17), got)


@pytest.mark.parametrize("nsample", [1, 8, 300])
def test_ball_query_op(nsample):
    xyz, new_xyz = _cloud(1), _cloud(2, N=40)
    torch.library.opcheck(torch.ops.scan2cap.ball_query.default,
                          (xyz, new_xyz, 0.3, nsample))
    got = torch.ops.scan2cap.ball_query(xyz, new_xyz, 0.3, nsample)
    assert got.dtype == torch.int32 and got.shape == (2, 40, nsample)
    assert torch.equal(got, grouping.ball_query_plain(xyz, new_xyz, 0.3,
                                                      nsample))
    assert torch.equal(grouping.ball_query(xyz, new_xyz, 0.3, nsample), got)


def test_group_points_op_and_gradient():
    g = torch.Generator().manual_seed(3)
    features = torch.randn(2, 50, 6, generator=g, requires_grad=True)
    idx = torch.randint(0, 50, (2, 9, 4), generator=g, dtype=torch.int32)
    torch.library.opcheck(torch.ops.scan2cap.group_points.default,
                          (features, idx))
    out = grouping.group_points(features, idx)
    assert torch.equal(out.detach(),
                       grouping.group_points_plain(features.detach(), idx))
    w = torch.randn(out.shape, generator=g)
    (out * w).sum().backward()
    want = torch.zeros(2, 50, 6)
    for b in range(2):
        want[b].index_add_(0, idx[b].reshape(-1).long(), w[b].reshape(-1, 6))
    assert torch.equal(features.grad, want)
    assert not grouping.group_points_forward(features, idx).requires_grad


def test_ops_have_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        xyz, q = torch.empty(3, 100, 3), torch.empty(3, 20, 3)
        feats, idx = torch.empty(3, 100, 5), torch.empty(3, 20, 8,
                                                         dtype=torch.int32)
        assert torch.ops.scan2cap.furthest_point_sample(xyz, 7).shape == (3, 7)
        bq = torch.ops.scan2cap.ball_query(xyz, q, 0.2, 8)
        assert bq.shape == (3, 20, 8) and bq.dtype == torch.int32
        assert torch.ops.scan2cap.group_points(feats, idx).shape == \
            (3, 20, 8, 5)
    assert library._LIB.ns == "scan2cap"


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    mp = pytest.MonkeyPatch()
    data = write_cli_data(root, np.random.RandomState(0))
    mp.setenv("SCAN2CAP_DATA", str(data))
    mp.setenv("SCAN2CAP_OUTPUT", str(root / "outputs"))
    mp.setenv("SCAN2CAP_TEST_TINY", "1")
    try:
        traincli.main(TINY + FLAGS + ["--use_normal", "--epoch", "1",
                                      "--val_step", "100", "--tag", "x"])
        run = next(p for p in (root / "outputs").iterdir()
                   if p.name.endswith("_X"))
        art = str(root / "model.pt2")
        export_model.main(["--folder", run.name, "--out", art,
                           "--device", "cpu"])
        serve, cfg, idx2word = export_model.build_serve(str(run), "cpu")
        # a val scene of the fixture, as the dataset gives it
        from scan2cap_torch.config import PathConfig
        from scan2cap_torch.data.dataset import ScannetReferenceDataset
        from scan2cap_torch.scripts.train import dataset_kwargs
        with open(data / "ScanRefer_filtered_val.json") as f:
            val = json.load(f)
        ds = ScannetReferenceDataset(
            val, sorted({d["scene_id"] for d in val}), split="val",
            **dataset_kwargs(PathConfig(), cfg))
        pc = torch.from_numpy(np.asarray(
            ds.__getitem__(0, rs=np.random.RandomState(0))["point_clouds"]
        ))[None]
        with torch.no_grad():
            eager = serve(pc)
        yield dict(root=root, run=run, art=art, serve=serve, cfg=cfg,
                   idx2word=idx2word, pc=pc, eager=eager)
    finally:
        mp.undo()


def test_artifact_files(exported):
    art = exported["art"]
    assert os.path.getsize(art) > 0
    with open(art + ".vocab.json") as f:
        assert json.load(f)["idx2word"] == exported["idx2word"]
    ep = torch.export.load(art)
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    counts = {op: sum(o.startswith(f"scan2cap.{op}") for o in ops)
              for op in ("furthest_point_sample", "ball_query",
                         "group_points")}
    # the CLI configuration: sa1 is not gather-lean at 4 channels
    assert counts == {"furthest_point_sample": 5, "ball_query": 5,
                      "group_points": 6}
    cfg = exported["cfg"]
    (spec,) = [n.meta["val"] for n in ep.graph.nodes
               if n.op == "placeholder" and n.name == "point_clouds"]
    assert tuple(spec.shape) == (1, cfg.num_points,
                                 3 + cfg.input_feature_dim)
    assert all(t.device.type == "cpu" for t in ep.state_dict.values())


def test_loaded_program_equals_eager_bitwise(exported):
    module = export_model.load(exported["art"], "cpu")
    with torch.no_grad():
        out = module(exported["pc"])
    assert set(out) == set(OUT_KEYS)
    assert out["tokens"].dtype == torch.int32
    for k in OUT_KEYS:
        assert torch.equal(out[k], exported["eager"][k]), k
    # the decoder starts from sos: a zero slot 0 decodes other tokens
    serve = exported["serve"]
    sos = serve.sos.clone()
    try:
        serve.sos.zero_()
        with torch.no_grad():
            zero = serve(exported["pc"])
    finally:
        serve.sos.copy_(sos)
    assert not torch.equal(zero["tokens"], out["tokens"])


def test_fresh_process_loads_with_the_ops_alone(exported, tmp_path):
    inp, outp = tmp_path / "in.npy", tmp_path / "out.npz"
    np.save(inp, exported["pc"].numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "import scan2cap_torch.ops.library\n"
        "from torch.export.passes import move_to_device_pass\n"
        f"ep = torch.export.load({exported['art']!r})\n"
        "m = move_to_device_pass(ep, 'cpu').module()\n"
        f"x = torch.from_numpy(np.load({str(inp)!r}))\n"
        "with torch.no_grad():\n"
        "    out = m(x)\n"
        f"np.savez({str(outp)!r}, **{{k: v.numpy() for k, v in out.items()}})\n"
        "print(sorted(k for k in sys.modules if k.startswith('scan2cap')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = eval(res.stdout.strip().splitlines()[-1])
    assert "scan2cap_torch.ops.library" in loaded
    assert not [m for m in loaded if m.split(".")[1:2] in
                (["models"], ["scripts"], ["train"], ["data"], ["eval"],
                 ["losses"])]
    got = np.load(outp)
    for k in OUT_KEYS:
        want = exported["eager"][k].numpy()
        assert got[k].dtype == want.dtype and got[k].tobytes() == \
            want.tobytes(), k


def test_matches_the_jax_serve(exported):
    import dataclasses
    import jax
    import jax.numpy as jnp
    from scan2cap_tpu.config import ModelConfig as JModelConfig
    from scan2cap_tpu.models import CapNet as JCapNet

    from scan2cap_torch.convert import flax_from_state_dict

    serve, cfg = exported["serve"], exported["cfg"]
    jcfg = JModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(JModelConfig)
                           if hasattr(cfg, f.name)})
    jmodel = JCapNet(jcfg, num_vocabs=serve.emb_table.shape[0])
    params, stats = flax_from_state_dict(serve.model.state_dict())
    table = jnp.asarray(serve.emb_table.numpy())
    sos = jnp.asarray(serve.sos.numpy())

    @jax.jit
    def jserve(point_clouds):
        lang = jnp.zeros((point_clouds.shape[0], jcfg.max_des_len + 2,
                          jcfg.emb_size), jnp.float32)
        out = jmodel.apply({"params": params, "batch_stats": stats},
                           {"point_clouds": point_clouds,
                            "lang_feat": lang.at[:, 0].set(sos),
                            "glove_emb_table": table},
                           use_tf=False, is_eval=True, train=False)
        return {"tokens": out["lang_cap"].astype(jnp.int32),
                "bbox_corner": out["bbox_corner"],
                "objectness_scores": out["objectness_scores"],
                "sem_cls_scores": out["sem_cls_scores"]}

    want = {k: np.asarray(v) for k, v in
            jserve(jnp.asarray(exported["pc"].numpy())).items()}
    got = export_model.load(exported["art"], "cpu")(exported["pc"])
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    for k in OUT_KEYS[1:]:
        w = want[k]
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=k)


def test_load_and_check(exported, capsys):
    module, out = export_model.main(["--load", exported["art"], "--check",
                                     "--device", "cpu"])
    assert out["tokens"].shape == exported["eager"]["tokens"].shape
    assert module(exported["pc"])["tokens"].shape == out["tokens"].shape
    assert "check ok: tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        export_model.main(["--device", "cpu"])
