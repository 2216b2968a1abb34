"""The port's live-inference slice against the JAX package.

``fg_logits_live`` and the ViT forward run on the same weights (the JAX
``init_dino``/``init_rev_decoder`` trees carried across by
``ucod_dpl_tpu_torch.models.convert``) and the same numpy pixels; the JAX
side runs its Pallas kernels in interpret mode.  Float32 tolerances are those
of tests/test_dino_parity.py.  Also: the port's ViT against a tiny HF model
built from its config (no download), exact weight and checkpoint round
trips, an import of the port that loads neither jax nor the JAX package
(at run time and by an AST scan of its sources), and the port's own copies
of the config loader, connected components and native resize against the
originals.
"""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.models import dba as JB
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.models import safetensors_io as JS
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dba as TB
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.models import safetensors_io as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    """hidden 128, 2 heads of 64, 3 layers: K1 and K6 are eligible on the JAX
    side (even heads, 2 * 64 % 128 == 0, hidden % 128 == 0)."""
    cfg = JD.DinoConfig(variant="dinov2", image_size=56, patch_size=14, hidden_size=128,
                        num_layers=3, num_heads=2, mlp_ratio=4)
    tcfg = TD.DinoConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jp, jd = JD.init_dino(k1, cfg), JB.init_rev_decoder(k2, cfg.hidden_size)
    tp = C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    td = C.decoder_from_jax(jax.tree_util.tree_map(np.asarray, jd))
    return cfg, tcfg, jp, jd, tp, td


@pytest.mark.parametrize("hw,size", [((56, 56), 8), ((56, 56), None), ((70, 56), 8), ((70, 56), None)])
def test_fg_logits_live_matches_jax(tiny, monkeypatch, hw, size):
    cfg, tcfg, jp, jd, tp, td = tiny
    px = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    fg_j, bg_j, _ = JB.fg_logits_live(jp, jd, jnp.asarray(px), cfg, compute_dtype=jnp.float32, size=size)
    fg_t, bg_t, _ = TB.fg_logits_live(tp, td, torch.from_numpy(px), tcfg, compute_dtype=torch.float32,
                                      size=size)
    assert tuple(fg_t.shape) == fg_j.shape
    np.testing.assert_allclose(fg_t.numpy(), np.asarray(fg_j), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(bg_t.numpy(), np.asarray(bg_j), rtol=2e-4, atol=2e-5)


def test_dino_forward_and_decoder_match_jax(tiny, monkeypatch):
    """The unfolded forward (key tokens and features) and the cache-fed
    decoder paths, including the O(C^2) orthogonality loss."""
    cfg, tcfg, jp, jd, tp, td = tiny
    px = np.random.default_rng(2).standard_normal((2, 70, 56, 3)).astype(np.float32)
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    out_j = JD.dino_forward(jp, jnp.asarray(px), cfg)
    out_t = TD.dino_forward(tp, torch.from_numpy(px), tcfg)
    assert set(out_t) == {"key_tokens", "key_features"}
    for key in out_t:
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]), rtol=1e-4, atol=1e-5)

    feats = out_j["key_features"]
    feats_t = torch.from_numpy(np.array(feats))
    got = TB.rev_decoder_forward(td, feats_t, with_loss=True)
    want = JB.rev_decoder_forward(jd, feats, with_loss=True)
    got_r = TB.rev_decoder_forward_resized(td, feats_t, 9, with_loss=True)
    want_r = JB.rev_decoder_forward_resized(jd, feats, 9, with_loss=True)
    for g, w in zip((*got, *got_r), (*want, *want_r)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("variant,size", [("dinov2", 32), ("dinov2", 48), ("dinov1", 32), ("dinov1", 48)])
def test_dino_forward_matches_hf(variant, size):
    """Native and interpolated position embeddings against HF Dinov2Model /
    ViTModel built from config (tolerances of tests/test_dino_parity.py)."""
    if variant == "dinov2":
        from transformers import Dinov2Config, Dinov2Model

        hf_cfg = Dinov2Config(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=2,
                              image_size=32, patch_size=8, attn_implementation="eager")
        torch.manual_seed(0)
        model = Dinov2Model(hf_cfg).eval()
    else:
        from transformers import ViTConfig, ViTModel

        hf_cfg = ViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                           image_size=32, patch_size=8, attn_implementation="eager")
        torch.manual_seed(1)
        model = ViTModel(hf_cfg, add_pooling_layer=False).eval()
    cfg = TD.DinoConfig(variant=variant, image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                        num_heads=4, mlp_ratio=2, layer_norm_eps=hf_cfg.layer_norm_eps,
                        use_layerscale=variant == "dinov2")
    params = TD.convert_hf_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, cfg)
    captured = {}
    model.encoder.layer[-1].attention.attention.key.register_forward_hook(
        lambda mod, inp, out: captured.__setitem__("key", out.detach())
    )
    x = np.random.default_rng(0).standard_normal((2, 3, size, size)).astype(np.float32)
    kwargs = {"interpolate_pos_encoding": True} if variant == "dinov1" else {}
    with torch.no_grad():
        model(torch.from_numpy(x), **kwargs)
        ours = TD.dino_forward(params, torch.from_numpy(x).permute(0, 2, 3, 1), cfg)
    torch.testing.assert_close(ours["key_tokens"], captured["key"], rtol=1e-4, atol=1e-4)
    g = size // 8
    torch.testing.assert_close(ours["key_features"].reshape(2, g * g, -1), captured["key"][:, 1:],
                               rtol=1e-4, atol=1e-4)


def test_cast_params_matches_per_call_casts(tiny):
    """Params cast to bf16 once give bit-for-bit the bf16 forward of the
    float32 masters (which casts at every use); LayerNorm params, q/k/v
    biases, the position embedding and the last layer (folded in f32) stay
    float32."""
    _, tcfg, _, _, tp, td = tiny
    cast = TD.cast_params(tp, torch.bfloat16)
    layer = cast["layers"][0]
    assert layer["fc1"]["w"].dtype == layer["out"]["b"].dtype == layer["ls1"].dtype == torch.bfloat16
    assert layer["q"]["w"].dtype == cast["patch_embed"]["kernel"].dtype == torch.bfloat16
    assert layer["q"]["b"].dtype == layer["norm1"]["scale"].dtype == torch.float32
    assert cast["pos_embed"].dtype == cast["final_norm"]["bias"].dtype == torch.float32
    assert cast["layers"][-1]["k"]["w"].dtype == torch.float32
    # float32 masters cast to float32 are the same tensors: no copy
    assert TD.cast_params(tp, torch.float32)["layers"][0]["fc1"]["w"] is tp["layers"][0]["fc1"]["w"]
    px = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 70, 56, 3)).astype(np.float32))
    with torch.inference_mode():
        want = TB.fg_logits_live(tp, td, px, tcfg, compute_dtype=torch.bfloat16, size=8)
        got = TB.fg_logits_live(cast, td, px, tcfg, compute_dtype=torch.bfloat16, size=8)
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        want = TD.dino_forward(tp, px, tcfg, compute_dtype=torch.bfloat16)["key_features"]
        got = TD.dino_forward(cast, px, tcfg, compute_dtype=torch.bfloat16)["key_features"]
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_weight_conversion_round_trips(tiny):
    cfg, tcfg, jp, jd, tp, td = tiny
    for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp)),
                    jax.tree_util.tree_leaves(C.dino_to_jax(tp))):
        np.testing.assert_array_equal(a, b)
    back = C.decoder_to_jax(td)
    for name, a in jd._asdict().items():
        np.testing.assert_array_equal(np.asarray(a), back[name])
    assert tp["patch_embed"]["kernel"].shape == (128, 3, 14, 14)  # OIHW
    assert tp["layers"][0]["fc1"]["w"].shape == (512, 128)  # (out, in)


def test_decoder_checkpoints_cross_load(tiny, tmp_path):
    """Port-written checkpoints load in the JAX package and vice versa, through
    real files (safetensors writes raw buffers)."""
    _, _, _, jd, _, td = tiny
    ema = TB.init_rev_decoder(3, 128)
    TS.save_decoder_checkpoint(str(tmp_path / "port.safetensors"), td, ema)
    j_student, j_ema = JS.load_decoder_checkpoint(str(tmp_path / "port.safetensors"))
    for port, jax_side in ((td, j_student), (ema, j_ema)):
        for name, a in C.decoder_to_jax(port).items():
            np.testing.assert_array_equal(a, np.asarray(getattr(jax_side, name)))
    JS.save_decoder_checkpoint(str(tmp_path / "jax.safetensors"), jd, jd)
    t_student, _ = TS.load_decoder_checkpoint(str(tmp_path / "jax.safetensors"))
    for a, b in zip(t_student, C.decoder_from_jax(jax.tree_util.tree_map(np.asarray, jd))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_port_imports_no_jax():
    """Importing every module of the port (the kernels' wrappers and the
    timing tools among them), loading a config, reading an image
    from a path for a request, running the LookTwice helpers and running the
    eval entry end to end on the CPU (``cli.eval_main``: runner, dataset cache
    build, evaluator, metrics), the train entry (``cli.train_main``: train
    loop, steps, checkpoints, validation), the pseudo-label generator, the
    CORAL eval entry (``cli.lt_eval_main``: LRDataset's caches, the refiner)
    and the CORAL train entry (``cli.lt_train_main``: m-patch caches, the
    refiner's losses and training loop) must import nothing of jax and nothing of the JAX package
    ``ucod_dpl_tpu``, not even its jax-free modules: an import of either is
    made to fail outright."""
    code = (
        "import glob, os, sys, tempfile, types\n"
        "import numpy as np\n"
        "for m in [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]:\n"
        "    del sys.modules[m]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ucod_dpl_tpu'] = None\n"
        "def jax_package():\n"
        "    return sorted(m for m in sys.modules if (m == 'ucod_dpl_tpu' or m.startswith('ucod_dpl_tpu.'))\n"
        "                  and sys.modules[m] is not None)\n"
        "import ucod_dpl_tpu_torch\n"
        "from ucod_dpl_tpu_torch import serving\n"
        "from ucod_dpl_tpu_torch.ops import _build, attention, fused_layers, patch_embed, pseudo_label, quant, resize\n"
        "from ucod_dpl_tpu_torch.tools import attention_ab, attn_outproj_ab, int8_ab, lnqkv_ab, patch_embed_ab, serve_ab\n"
        "from ucod_dpl_tpu_torch.tools import dryrun_multichip, soak_preempt\n"
        "from ucod_dpl_tpu_torch.models import convert, dba, dino, discriminator, lora, safetensors_io, udlr\n"
        "from ucod_dpl_tpu_torch.data import feature_extractor, transforms\n"
        "from ucod_dpl_tpu_torch.data import dataset\n"
        "from ucod_dpl_tpu_torch.engine import checkpoint, coral_loop, eval_loop, preempt, runner, train_loop\n"
        "from ucod_dpl_tpu_torch.engine import train_step\n"
        "from ucod_dpl_tpu_torch.parallel import distributed, mesh, tp\n"
        "from ucod_dpl_tpu_torch.config import load_config\n"
        "from ucod_dpl_tpu_torch.utils import bilateral_solver, components, fileio, logger, metrics, native\n"
        "from ucod_dpl_tpu_torch.utils import profiling, progress, registry, seed, visualize\n"
        "from ucod_dpl_tpu_torch import cli\n"
        "assert not jax_package(), jax_package()\n"
        "cfg = load_config('configs/uscod/UCOD-DPL_dinov2.py')\n"
        "assert cfg.dataset_cfg.feature_extractor_cfg.type == 'dinov2'\n"
        "from PIL import Image\n"
        "path = os.path.join(tempfile.mkdtemp(), 'im.png')\n"
        "rgb = (np.random.default_rng(0).random((40, 50, 3)) * 255).astype(np.uint8)\n"
        "Image.fromarray(rgb).save(path)\n"
        "arr, img = serving.Predictor._load(types.SimpleNamespace(image_size=(28, 28)), path)\n"
        "assert arr.shape == (28, 28, 3) and img.size == (50, 40)\n"
        "mask = np.zeros((28, 28), np.float32)\n"
        "mask[3:6, 4:8] = 1\n"
        "boxes = eval_loop.find_refine_bboxes(mask, (28, 28), 0.15, 'dynamic')\n"
        "out = eval_loop.refine_with_crops(img, boxes, mask, (28, 28),\n"
        "                                  lambda b: np.ones((b.shape[0], 4, 4), np.float32))\n"
        "assert out.shape == (28, 28)\n"
        "assert ucod_dpl_tpu_torch.Predictor is serving.Predictor\n"
        "root = tempfile.mkdtemp()\n"
        "for sub in ('im', 'gt'):\n"
        "    os.makedirs(os.path.join(root, 'RefCOD', 'SYN', sub))\n"
        "for i in range(2):\n"
        "    Image.fromarray(rgb).save(os.path.join(root, 'RefCOD', 'SYN', 'im', f'{i}.jpg'))\n"
        "    Image.fromarray((rgb[..., 0] > 128).astype(np.uint8) * 255).save(\n"
        "        os.path.join(root, 'RefCOD', 'SYN', 'gt', f'{i}.png'))\n"
        "arch = {'hidden_size': 32, 'num_layers': 1, 'num_heads': 2, 'patch_size': 14, 'image_size': 28}\n"
        "with open(os.path.join(root, 'tiny.py'), 'w') as f:\n"
        "    f.write('_BASE_ = [' + repr(os.path.abspath('configs/uscod/UCOD-DPL_dinov2.py')) + ']\\n'\n"
        "            'cfg = dict(_BASE_=_BASE_, model_cfg=dict(dim=32, feature_size=4), '\n"
        "            'dataset_cfg=dict(feature_extractor_cfg=dict(arch=' + repr(arch) + ')))\\n')\n"
        "runners = cli.eval_main(['-c', os.path.join(root, 'tiny.py'), '--device', 'cpu', '--work_dir', root,\n"
        "    '--datasets', 'SYN', '--opts', 'dataset_cfg.dataset_dir', os.path.join(root, 'RefCOD'),\n"
        "    'dataset_cfg.cache_dir', os.path.join(root, 'cache'), 'dataset_cfg.valset_cfg.image_size', '(28, 28)',\n"
        "    'tpu_cfg.compute_dtype', 'float32', 'val_cfg.look_twice_th', '0.95'])\n"
        "stats = metrics.CODStatistics()\n"
        "stats.step(mask[None], mask[None])\n"
        "assert stats.get_result()['MAE'] == 0.0\n"
        "assert runners['SYN'].evaluator.seconds > 0 and runners['SYN'].val_dataset.caches.get('features').mode == 'r'\n"
        "pl = fileio.ArrayCache(os.path.join(root, 'cache', 'pseudo_label_cache', 'SYN'))\n"
        "for i in range(2):\n"
        "    pl.write(i, np.full((2, 2, 1), 0.9, np.float32))\n"
        "pl.flush()\n"
        "trained = cli.train_main(['-c', os.path.join(root, 'tiny.py'), '--device', 'cpu', '--work_dir', root,\n"
        "    '--opts', 'dataset_cfg.dataset_dir', os.path.join(root, 'RefCOD'),\n"
        "    'dataset_cfg.cache_dir', os.path.join(root, 'cache'), 'dataset_cfg.trainset_cfg.DATASET', 'SYN',\n"
        "    'dataset_cfg.valset_cfg.DATASET', 'SYN', 'dataset_cfg.trainset_cfg.image_size', '(28, 28)',\n"
        "    'dataset_cfg.valset_cfg.image_size', '(28, 28)', 'dataset_cfg.trainloader_cfg.batch_size', '2',\n"
        "    'tpu_cfg.compute_dtype', 'float32', 'train_cfg.max_epoch', '2', 'train_cfg.start_finetune', '-1',\n"
        "    'train_cfg.save_cfg.save_mode', 'all', 'train_cfg.save_cfg.save_interval', '2',\n"
        "    'train_cfg.save_cfg.start_save', '0', 'val_cfg.val_interval', '2', 'val_cfg.start_val', '2'])\n"
        "assert trained.train_loop.state.opt.count == 1 and trained.train_loop.best_result is not None\n"
        "assert os.path.exists(os.path.join(trained.ckp_dir, 'state_epoch2.npz'))\n"
        "out = cli.generate_pseudo_label_main(['--dataset', 'SYN', '--image_path', os.path.join(root, 'RefCOD', '{}', 'im'),\n"
        "    '--cache_path', os.path.join(root, 'pl'), '--backbone_weights', root, '--image_size', '28',\n"
        "    '--device', 'cpu'])\n"
        "assert fileio.ArrayCache(out).read(1).shape == (2, 2, 1)\n"
        "with open(os.path.join(root, 'coral.py'), 'w') as f:\n"
        "    f.write('cfg = dict(_BASE_=[' + repr(os.path.abspath('configs/uscod/CORAL_dinov2.py')) + '], '\n"
        "            'model_cfg=dict(dim=32, feature_size=4, window_length=4), '\n"
        "            'dataset_cfg=dict(feature_extractor_cfg=dict(arch=' + repr(arch) + ')))\\n')\n"
        "refined = cli.lt_eval_main(['-c', os.path.join(root, 'coral.py'), '--device', 'cpu', '--work_dir', root,\n"
        "    '--datasets', 'SYN', '--opts', 'dataset_cfg.dataset_dir', os.path.join(root, 'RefCOD'),\n"
        "    'dataset_cfg.cache_dir', os.path.join(root, 'cache'), 'dataset_cfg.valset_cfg.image_size', '(28, 28)',\n"
        "    'tpu_cfg.compute_dtype', 'float32'])\n"
        "assert set(refined['SYN'].evaluator.result) == set(stats.get_result())\n"
        "coral = cli.lt_train_main(['-c', os.path.join(root, 'coral.py'), '--device', 'cpu', '--work_dir', root,\n"
        "    '--opts', 'dataset_cfg.dataset_dir', os.path.join(root, 'RefCOD'),\n"
        "    'dataset_cfg.cache_dir', os.path.join(root, 'cache'), 'dataset_cfg.trainset_cfg.DATASET', 'SYN',\n"
        "    'dataset_cfg.trainset_cfg.image_size', '(28, 28)', 'dataset_cfg.valset_cfg.image_size', '(28, 28)',\n"
        "    'tpu_cfg.compute_dtype', 'float32', 'train_cfg.max_epoch', '1'])\n"
        "assert len(coral.train_loop.epoch_losses) == 1 and coral.train_dataset.require_m_patches\n"
        "assert os.path.exists(os.path.join(coral.log_path, 'refiner_ckp', 'epoch1_ema.safetensors'))\n"
        "os.environ['UCOD_DIST'] = '1'  # a gloo group of one: the process-group path without jax\n"
        "dp = cli.train_main(['-c', os.path.join(root, 'tiny.py'), '--device', 'cpu', '--work_dir', root + '/dp',\n"
        "    '--opts', 'dataset_cfg.dataset_dir', os.path.join(root, 'RefCOD'),\n"
        "    'dataset_cfg.cache_dir', os.path.join(root, 'cache'), 'dataset_cfg.trainset_cfg.DATASET', 'SYN',\n"
        "    'dataset_cfg.valset_cfg.DATASET', 'SYN', 'dataset_cfg.trainset_cfg.image_size', '(28, 28)',\n"
        "    'dataset_cfg.valset_cfg.image_size', '(28, 28)', 'dataset_cfg.trainloader_cfg.batch_size', '2',\n"
        "    'tpu_cfg.compute_dtype', 'float32', 'train_cfg.max_epoch', '2', 'train_cfg.start_finetune', '-1'])\n"
        "import torch\n"
        "assert torch.distributed.is_initialized() and distributed.process_count() == 1\n"
        "assert distributed.grad_all_reduce['calls'] == 0, distributed.grad_all_reduce  # a plain run\n"
        "assert all(torch.isfinite(t).all() for t in dp.decoder_params)\n"
        "distributed.shutdown()\n"
        "bad = [m for m in sys.modules if m.startswith('jax') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "assert not jax_package(), jax_package()\n"
        "print('NO-JAX-OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO-JAX-OK" in out.stdout


def _port_files():
    return sorted(glob.glob(os.path.join(REPO, "ucod_dpl_tpu_torch", "**", "*.py"), recursive=True)) + [
        os.path.join(REPO, "chip_smoke.py")]


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    """An AST scan of every module of the port and of chip_smoke.py: no
    ``import``/``from`` of jax or of ``ucod_dpl_tpu`` (the package root or
    any submodule), at module level or inside a function."""
    def banned(name):
        return any(name == root or name.startswith(root + ".") for root in ("jax", "ucod_dpl_tpu"))

    found = []
    for path in _port_files():
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names if banned(n)]
    assert len(_port_files()) > 20
    assert not found, found


CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "configs", "**", "*.py"),
                                                             recursive=True))


@pytest.mark.parametrize("path", CONFIGS)
def test_port_config_copy_loads_what_the_jax_package_loads(path):
    from ucod_dpl_tpu.config import load_config as jax_load_config
    from ucod_dpl_tpu_torch.config import load_config

    ours = load_config(os.path.join(REPO, path))
    assert ours.to_dict() == jax_load_config(os.path.join(REPO, path)).to_dict()
    assert ours.to_dict()  # every config file defines something


def test_port_config_copy_overrides_and_freezes_like_the_jax_package():
    from ucod_dpl_tpu.config import load_config as jax_load_config
    from ucod_dpl_tpu_torch.config import load_config

    path = os.path.join(REPO, "configs", "uscod", "UCOD-DPL_dinov2.py")
    opts = ["train_cfg.max_epoch", "3", "model_cfg.feature_size", "34"]
    ours, theirs = load_config(path, opts), jax_load_config(path, opts)
    assert ours.to_dict() == theirs.to_dict() and ours.train_cfg.max_epoch == 3
    for cfg in (ours, theirs):
        with pytest.raises(KeyError):
            cfg.merge_from_list(["train_cfg.no_such_key", "1"])
        cfg.freeze()
        with pytest.raises(AttributeError):
            cfg.train_cfg.max_epoch = 4


def test_port_components_copy_matches_the_jax_package():
    from ucod_dpl_tpu.utils import components as JC
    from ucod_dpl_tpu_torch.utils import components as TC

    rng = np.random.default_rng(0)
    for density in (0.0, 0.05, 0.3, 0.6):
        mask = (rng.random((64, 80)) < density).astype(np.uint8)
        n_ours, labels_ours = TC.connected_components(mask)
        n_theirs, labels_theirs = JC.connected_components(mask)
        assert n_ours == n_theirs
        np.testing.assert_array_equal(labels_ours, labels_theirs)
        for i in range(1, min(n_ours, 5) + 1):
            comp = (labels_ours == i).astype(np.uint8)
            assert TC.bounding_rect(comp) == JC.bounding_rect(comp)
        assert TC.bounding_rect(mask) == JC.bounding_rect(mask)


@pytest.mark.parametrize("shape,size", [((37, 53, 3), (518, 518)), ((600, 480), (68, 90)), ((9, 7, 1), (4, 11))])
def test_port_native_resize_is_bit_equal_to_the_jax_package(shape, size):
    """Both libraries are built here (g++, libjpeg, libpng); the port builds
    its own copy under build/ and never writes to native/."""
    from ucod_dpl_tpu.utils import native as JN
    from ucod_dpl_tpu_torch.utils import native as TN

    arr = (np.random.default_rng(sum(shape)).random(shape) * 255).astype(np.uint8)
    ours, theirs = TN.resize_u8_native(arr, size), JN.resize_u8_native(arr, size)
    assert ours is not None and theirs is not None
    assert ours.shape == theirs.shape and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    assert TN._IMAGEPIPE_SO.startswith(os.path.join(REPO, "build"))


# The name diff: every public function, class and method of a JAX module has
# a counterpart of the same name in the port's module of the same path, but
# for the TPU-only names the port leaves out by design (ROADMAP, Queue 1):
# the Mosaic block laws and JAX's global attention routing switch, whose
# place the port's ``differentiable=`` argument takes.
NAME_DIFF_EXCLUDED = {
    "ops/pallas_legality.py": {"<module>"},
    "ops/attention.py": {"differentiable_mode", "use_pallas"},
}
JAX_MODULES = sorted(os.path.relpath(p, os.path.join(REPO, "ucod_dpl_tpu"))
                     for p in glob.glob(os.path.join(REPO, "ucod_dpl_tpu", "**", "*.py"), recursive=True))


def _public_names(path):
    """The public top-level functions and classes of a module, and the
    public methods of its public classes (``Class.method``)."""
    names = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{f.name}" for f in node.body
                          if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)) and not f.name.startswith("_")}
    return names


def _defined_names(path):
    """Every name a module binds at its top level (functions, classes and
    their methods, assignments, imports)."""
    names = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{f.name}" for f in node.body
                          if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
    return names


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_every_public_name_of_the_jax_module(module):
    """An AST scan of ``ucod_dpl_tpu/<module>`` against
    ``ucod_dpl_tpu_torch/<module>``: what the port lacks is exactly the
    module's documented TPU-only exclusions."""
    port = os.path.join(REPO, "ucod_dpl_tpu_torch", module)
    if os.path.exists(port):
        missing = _public_names(os.path.join(REPO, "ucod_dpl_tpu", module)) - _defined_names(port)
    else:
        missing = {"<module>"}
    assert missing == NAME_DIFF_EXCLUDED.get(module, set()), f"{module}: the port lacks {sorted(missing)}"
