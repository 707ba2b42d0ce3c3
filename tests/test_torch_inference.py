"""The port's sampled-inference slice end to end against the JAX reference,
plus the port's import and device rules.

A JAX NALPTrainer(cached_hop, fused_cache) and the port's NALPTrainer run
run_inference over the same graph with converted params. In fp32 the
embeddings match at rtol = atol = 1e-5 (same math, different summation
order); in bf16 at 3e-2 of the output scale (see test_torch_models.py for
why). The exported ids must be equal, each once.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.inference.inferencer import (
    InferenceConfig as JaxInferenceConfig,
    run_inference as jax_run_inference,
)
from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.models.link_prediction import (
    LinkPredictionDecoder as JaxDecoder,
    LinkPredictionGNN as JaxLPGNN,
)
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu.training.trainer import (
    NALPTrainer as JaxNALPTrainer,
    NALPTrainerConfig as JaxNALPTrainerConfig,
)
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.inference.inferencer import (
    InferenceConfig,
    node_batches,
    run_inference,
)
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.trainer import NALPTrainer, NALPTrainerConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, E, D, HID, OUT, BATCH = 500, 4000, 16, 32, 16, 64
FANOUTS = (4, 3)


class Sink:
    def __init__(self):
        self.ids, self.embs, self.flushed = [], [], 0

    def add_embeddings(self, ids, emb):
        self.ids.append(np.asarray(ids))
        self.embs.append(np.asarray(emb, np.float32))

    def flush(self):
        self.flushed += 1


class JaxInferencer:
    def __init__(self, trainer, params):
        self.trainer, self.params = trainer, params

    def infer_batch(self, ids):
        return self.trainer.encode_batch(self.params, ids)


def _graph_arrays(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    keep = ~np.isin(dst, (5, 77))  # two nodes without in-neighbors
    return src[keep], dst[keep], rng.normal(size=(N, D)).astype(np.float32)


def _run_both(jdt, tdt, cached_hop=True, fused_cache=True):
    src, dst, x = _graph_arrays()
    jg = JaxDeviceGraph.from_hetero(JaxHeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N, node_features=x),
        supervision_edges=np.stack([src, dst]))
    jcfg = JaxNALPTrainerConfig(fanouts=FANOUTS, cached_hop=cached_hop,
                                fused_cache=fused_cache, seed=3)
    jt = JaxNALPTrainer(
        JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT, dtype=jdt),
                 decoder=JaxDecoder()), jg, jcfg)
    params = jt.init_state(jax.random.PRNGKey(0), batch_size=BATCH).params
    jsink = Sink()
    jn = jax_run_inference(JaxInferencer(jt, params), N, jsink,
                           JaxInferenceConfig(batch_size=BATCH))

    pg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N, node_features=x),
        supervision_edges=np.stack([src, dst]), device="cpu")
    model = LinkPredictionGNN(GNNEncoder(D, HID, OUT, dtype=tdt),
                              LinkPredictionDecoder())
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    pcfg = NALPTrainerConfig(fanouts=FANOUTS, cached_hop=cached_hop,
                             fused_cache=fused_cache, seed=3)
    pt = NALPTrainer(model, pg, pcfg, device="cpu")
    psink = Sink()
    pn = run_inference(pt, N, psink, InferenceConfig(batch_size=BATCH),
                       device="cpu")
    assert jn == pn == N and jsink.flushed == psink.flushed == 1
    return jsink, psink


@pytest.mark.parametrize("cached_hop,fused_cache", [
    (True, True), (True, False), (False, False)])
def test_run_inference_matches_jax_f32(cached_hop, fused_cache):
    jsink, psink = _run_both(jnp.float32, torch.float32, cached_hop,
                             fused_cache)
    jids, pids = np.concatenate(jsink.ids), np.concatenate(psink.ids)
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_array_equal(np.sort(pids), np.arange(N))
    np.testing.assert_allclose(np.concatenate(psink.embs),
                               np.concatenate(jsink.embs),
                               rtol=1e-5, atol=1e-5)


def test_run_inference_matches_jax_bf16():
    jsink, psink = _run_both(jnp.bfloat16, torch.bfloat16)
    want = np.concatenate(jsink.embs)
    got = np.concatenate(psink.embs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


def test_node_batches_pad_and_shard():
    cfg = InferenceConfig(batch_size=4, worker_rank=1, num_workers=2)
    batches = list(node_batches(11, cfg))
    assert [v for _, v in batches] == [4, 1]
    np.testing.assert_array_equal(batches[0][0], [1, 3, 5, 7])
    np.testing.assert_array_equal(batches[1][0], [9, 0, 0, 0])


def test_init_params_is_seeded_and_device_independent():
    def make():
        src, dst, x = _graph_arrays()
        g = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
            src=src, dst=dst, num_nodes=N, node_features=x), device="cpu")
        model = LinkPredictionGNN(GNNEncoder(D, HID, OUT),
                                  LinkPredictionDecoder())
        t = NALPTrainer(model, g, NALPTrainerConfig(fanouts=FANOUTS,
                                                    cached_hop=True),
                        device="cpu")
        t.init_params(7)
        return t
    a, b = make(), make()
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    w = a.model.encoder.convs[0].lin_self.weight
    assert 0.5 < float(w.detach().std() * np.sqrt(D)) < 1.5
    assert not a.model.encoder.convs[0].lin_self.bias.detach().any()
    emb = a.encode_batch(np.arange(BATCH))
    assert emb.shape == (BATCH, OUT) and torch.isfinite(emb).all()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, x = _graph_arrays()
    g = HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                node_features=x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceGraph.from_hetero(g)
    pg = DeviceGraph.from_hetero(g, device="cpu")
    model = LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NALPTrainer(model, pg, NALPTrainerConfig(fanouts=FANOUTS))
    pt = NALPTrainer(model, pg, NALPTrainerConfig(fanouts=FANOUTS),
                     device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inference(pt, N, Sink())


def test_unported_branches_raise():
    src, dst, x = _graph_arrays()
    g = HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                node_features=x)
    for kw in ({"quantize_features": True}, {"sampling_weight_index": 0}):
        with pytest.raises(NotImplementedError, match="not ported"):
            DeviceGraph.from_hetero(g, device="cpu", **kw)
    ge = HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                 node_features=x,
                                 edge_features=np.ones((len(src), 2)))
    with pytest.raises(NotImplementedError, match="hydrate_edges"):
        DeviceGraph.from_hetero(ge, device="cpu")


_GUARD = r"""
import importlib, pkgutil, sys
import gigl_tpu_torch
for m in pkgutil.walk_packages(gigl_tpu_torch.__path__, "gigl_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(
    name for name in sys.modules
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
    or name == "gigl_tpu" or name.startswith("gigl_tpu."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_gigl_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py fails, and prints no result, without a card — both in
    the checkout and alone in a directory without the package."""
    script = (REPO / "chip_smoke.py").read_text()
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    for cwd, path in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
