"""Sharded evaluation of the port over 2 gloo ranks on the CPU: ``cli eval``
and ``cli lt_eval``, each against the port's one-process run and the JAX
package's one-process entry on the same world.

The ranks share one cache directory: process 0 builds each cache (the
feature cache, and for CORAL the grid-patch cache) and writes its
``index.json`` once, while process 1 polls for it.  The val loaders split 5
images into ragged shards (3 and 2); the metric gather brings every rank the
same per-image values, so both ranks return the same metric dict, within
atol 1e-12 of a one-process run (the hold of
tests/test_distributed_eval.py:54 on the JAX package: float64 means summed
in another order), and only process 0 prints the result lines.  Those
lines are the JAX package's, and its metrics are within atol 1e-5 (the hold
of tests/test_torch_coral.py's lt_eval test; the eval test of
tests/test_torch_eval.py compares the printed lines).  Val batch 1,
the shipped configs' (the CORAL refiner's batch-global maxima would
otherwise see which images share a batch).  Every run is a subprocess with
the same thread count, so that the float32 features agree bit for bit.
"""

import dataclasses
import json

import pytest
import torch

from ucod_dpl_tpu import cli as JCLI
from ucod_dpl_tpu.engine.runner import LocalRefineRunner as JLRRunner
from ucod_dpl_tpu.engine.runner import Runner as JRunner
from ucod_dpl_tpu_torch.config import CfgNode as TCfg
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward_resized
from ucod_dpl_tpu_torch.models.dino import DinoConfig, init_dino, save_hf_checkpoint
from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint
from ucod_dpl_tpu_torch.models.udlr import init_sparse_refiner, save_refiner_checkpoint

import test_torch_coral as coral
import test_torch_eval as ev
from test_torch_distributed import result_lines, run_ranks

pytestmark = pytest.mark.heavy  # multi-process: excluded from the quick loop

_EVAL = '''
import json, os, sys
from ucod_dpl_tpu_torch import cli
from ucod_dpl_tpu_torch.utils import fileio

argv, command = json.loads(sys.argv[1]), sys.argv[2]
flushes = []
orig_flush = fileio.ArrayCache.flush

def flush(self, *a, **k):
    flushes.append(self.base_path.parts[-4][: -len("_cache")])  # {cache_dir}/{kind}_cache/{fe}/{mode}/{set}
    return orig_flush(self, *a, **k)

fileio.ArrayCache.flush = flush
runner = getattr(cli, command)(argv)["TINY"]
print("RESULT " + json.dumps({"result": runner.evaluator.result, "flushes": flushes,
                              "batches": len(runner.val_dataloader)}))
'''


def _world(root, kind):
    """5 labelled images, a seeded backbone checkpoint and a decoder whose
    first pass marks about a third of the pixels (its fg bias at the 67th
    percentile of its logits on these images), and for CORAL a seeded
    refiner checkpoint (the packages seed their own refiner inits from
    different generators); returns the entry's checkpoint flags."""
    mod = ev if kind == "eval" else coral
    if kind == "eval":
        ev._make_dataset(root / "RefCOD", n=5)
    else:
        coral._write_images(root / "RefCOD", "TINY", 5, 0)
    dcfg = dataclasses.replace(DinoConfig.from_type("dinov2"), **mod.ARCH)
    (root / "hf").mkdir()
    save_hf_checkpoint(str(root / "hf" / "model.safetensors"), init_dino(0, dcfg), dcfg)
    fe = FeatureExtractor(TCfg(mod._cfg_dict(root, "x", root / "hf")["dataset_cfg"]["feature_extractor_cfg"]),
                          device="cpu")
    paths = sorted((root / "RefCOD" / "TINY" / "im").iterdir())
    with torch.no_grad():
        feats = torch.from_numpy(fe.extract(load_image_batch_transform(paths, (56, 56))))
        dec = init_rev_decoder(1, mod.DIM)
        fg = rev_decoder_forward_resized(dec, feats, 8)[0]
    ckpt = str(root / "decoder.safetensors")
    save_decoder_checkpoint(ckpt, dec._replace(conv_out_fg_b=dec.conv_out_fg_b - torch.quantile(fg.flatten(), 0.67)),
                            init_rev_decoder(2, mod.DIM))
    if kind == "eval":
        return ["--load_from", ckpt]
    refiner = str(root / "refiner.safetensors")
    save_refiner_checkpoint(refiner, init_sparse_refiner(9, dim=mod.DIM))
    return ["--load_from", ckpt, "--refiner_path", refiner]


@pytest.mark.parametrize("command", ["eval_main", "lt_eval_main"])
def test_two_ranks_evaluate_as_one_process(tmp_path, monkeypatch, capsys, command):
    """``cli eval`` (LookTwice, crops forced by ``look_twice_th`` 0.95) or
    ``cli lt_eval`` (a seeded refiner, no m-patches) over 2 ranks on one
    shared cache directory, against the same entry in one process, and
    against the JAX package's same entry (its own cache) on the same
    images, backbone checkpoint and decoder file."""
    kind = "eval" if command == "eval_main" else "lt_eval"
    ckpts = _world(tmp_path, kind)
    runs, argvs = {}, {}
    for tag in ("one", "two", "jax"):
        if kind == "eval":
            cfg = ev._cfg_dict(tmp_path, tag, tmp_path / "hf")
        else:
            cfg = coral._cfg_dict(tmp_path, tag, tmp_path / "hf", val_batch=1)
        (tmp_path / f"{tag}.py").write_text(f"cfg = {cfg!r}\n")
        argvs[tag] = ["-c", str(tmp_path / f"{tag}.py"), "--work_dir", str(tmp_path / f"wd_{tag}"), *ckpts,
                      "--datasets", "TINY"]
    for tag, world in (("one", 0), ("two", 2)):
        runs[tag] = run_ranks(tmp_path, f"worker_{tag}", _EVAL, world,
                              args=(json.dumps(argvs[tag] + ["--device", "cpu"]), command))
    # the JAX package's one-process entry; its CLI returns nothing, so the
    # runner's result is recorded on its way out
    jres = []
    launch = "launch_val_look_twice" if kind == "eval" else "launch_val"
    jcls = JRunner if kind == "eval" else JLRRunner
    orig = getattr(jcls, launch)
    monkeypatch.setattr(jcls, launch, lambda self: jres.append(orig(self)) or jres[-1])
    capsys.readouterr()
    getattr(JCLI, command)(argvs["jax"])
    jlines = [line for line in capsys.readouterr().out.splitlines() if line.startswith(("running", "TINY"))]
    (one,) = [result_lines(out)[0] for _, out in runs["one"]]
    two = [result_lines(out)[0] for _, out in runs["two"]]
    caches = ["features"] if kind == "eval" else ["features", "patch"]
    assert one["flushes"] == caches and two[0]["flushes"] == caches and two[1]["flushes"] == []
    assert [r["batches"] for r in two] == [3, 2] and one["batches"] == 5
    assert two[0]["result"] == two[1]["result"]
    assert set(one["result"]) == set(ev.KEYS)
    for k in ev.KEYS:
        assert abs(two[0]["result"][k] - one["result"][k]) <= 1e-12, (k, two[0]["result"][k], one["result"][k])
    printed = [[line for line in out.splitlines() if line.startswith(("running", "TINY"))] for _, out in runs["two"]]
    assert len(printed[0]) == 2 and printed[1] == []
    assert printed[0] == jlines, (printed[0], jlines)
    (want,) = jres
    assert set(want) == set(ev.KEYS)
    for k in ev.KEYS:
        assert abs(two[0]["result"][k] - want[k]) <= 1e-5, (k, two[0]["result"][k], want[k])
