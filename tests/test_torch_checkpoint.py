"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
JAX package's, on the CPU: the same on-disk format, so each package
restores the other's checkpoints bit for bit, and the port's training
driver's restart drill.

The state is the JAX train tests' tiny model's (``default_config(vocab=
128)`` cut to 2 layers of width 64): bf16 parameters, f32 moments, an
int32 step and, with compression, an f32 error state.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.launch.train import default_config as r_default_config
from repro.models import build_model as r_build
from repro.train import checkpoint as RCK
from repro.train import optimizer as RO
from repro.train import train_step as RT

from repro_torch.launch.train import default_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.train.train_step import TrainState, abstract_state

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)

torch.set_num_threads(1)


def _model():
    return build_model(dataclasses.replace(default_config(vocab=128), **TINY),
                       device="cpu")


def _jax_state(compress: bool):
    rmodel = r_build(dataclasses.replace(r_default_config(vocab=128), **TINY))
    opt = RO.AdamW(lr=lambda s: 1e-3)
    state = RT.init_state(rmodel, opt, jax.random.PRNGKey(0),
                          compress=compress)
    # non-zero moments, step and error, so every leaf carries values
    rng = np.random.default_rng(3)
    fill = lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                                 ).astype(a.dtype)
    return state._replace(
        opt=state.opt._replace(step=jnp.asarray(7, jnp.int32),
                               m=jax.tree.map(fill, state.opt.m),
                               v=jax.tree.map(fill, state.opt.v)),
        error=None if state.error is None else jax.tree.map(fill, state.error))


def _port_state(rstate):
    to = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    return TrainState(
        to(rstate.params),
        AdamWState(torch.tensor(int(rstate.opt.step), dtype=torch.int32),
                   to(rstate.opt.m), to(rstate.opt.v)),
        None if rstate.error is None else to(rstate.error))


def _bits(a) -> np.ndarray:
    """The raw bits of a leaf of either package, as unsigned integers."""
    if isinstance(a, torch.Tensor):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    else:
        a = np.asarray(a)
        a = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _port_leaves(state):
    return [leaf for _, leaf in ckpt._paths(state)]


def _jax_leaves(state):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx",
                                                    getattr(p, "name", p))))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


def test_save_restore_roundtrip(tmp_path):
    state = _port_state(_jax_state(compress=True))
    path = ckpt.save(str(tmp_path), 7, state, extra={"note": "x"})
    assert os.path.basename(path) == "step_00000007"
    restored, manifest = ckpt.restore(str(tmp_path), 7, state, device="cpu")
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "x"
    assert isinstance(restored, TrainState)
    assert isinstance(restored.opt, AdamWState)
    for a, b in zip(_port_leaves(state), _port_leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_restore_into_the_abstract_state(tmp_path):
    state = _port_state(_jax_state(compress=False))
    ckpt.save(str(tmp_path), 3, state)
    like = abstract_state(_model(), AdamW(lr=lambda s: 1e-3))
    restored, _ = ckpt.restore_latest(str(tmp_path), like, device="cpu")
    want, got = dict(ckpt._paths(state)), dict(ckpt._paths(restored))
    assert set(got) == set(want)
    for key, leaf in got.items():
        assert leaf.device.type == "cpu"
        np.testing.assert_array_equal(_bits(leaf), _bits(want[key]))


def test_restore_refuses_another_shape(tmp_path):
    state = _port_state(_jax_state(compress=False))
    ckpt.save(str(tmp_path), 1, state)
    bad = state._replace(params={**state.params,
                                 "embed": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, bad, device="cpu")


def test_latest_step_ignores_tmp(tmp_path):
    state = _port_state(_jax_state(compress=False))
    ckpt.save(str(tmp_path), 5, state)
    os.makedirs(tmp_path / "step_00000009.tmp")  # simulated crash
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.restore_latest(str(tmp_path / "none"), state) == (None, None)


@pytest.mark.parametrize("compress", [False, True])
def test_jax_checkpoint_restored_by_the_port(tmp_path, compress):
    rstate = _jax_state(compress)
    RCK.save(str(tmp_path), 7, rstate, extra={"loader": {"cursor": [1]}})
    like = _port_state(rstate)
    restored, manifest = ckpt.restore(str(tmp_path), 7, like, device="cpu")
    assert manifest["extra"] == {"loader": {"cursor": [1]}}
    want = _jax_leaves(rstate)
    got = dict(ckpt._paths(restored))
    assert set(got) == set(want)
    for key, leaf in got.items():
        assert leaf.shape == want[key].shape
        np.testing.assert_array_equal(_bits(leaf), _bits(want[key]))
    assert restored.params["embed"].dtype == torch.bfloat16
    assert restored.opt.step.dtype == torch.int32


@pytest.mark.parametrize("compress", [False, True])
def test_port_checkpoint_restored_by_jax(tmp_path, compress):
    rstate = _jax_state(compress)
    ckpt.save(str(tmp_path / "port"), 7, _port_state(rstate))
    RCK.save(str(tmp_path / "jax"), 7, rstate)
    manifests = [json.loads((tmp_path / d / "step_00000007" /
                             "manifest.json").read_text())
                 for d in ("port", "jax")]
    for field in ("step", "keys", "shapes", "dtypes"):
        assert manifests[0][field] == manifests[1][field], field
    restored, _ = RCK.restore(str(tmp_path / "port"), 7, rstate)
    for (ka, a), (kb, b) in zip(_jax_leaves(rstate).items(),
                                _jax_leaves(restored).items()):
        assert ka == kb and a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_holds_no_torch_dtype_names(tmp_path):
    ckpt.save(str(tmp_path), 1, _port_state(_jax_state(compress=True)))
    manifest = json.loads((tmp_path / "step_00000001" /
                           "manifest.json").read_text())
    assert set(manifest["dtypes"].values()) == {"bfloat16", "float32",
                                                "int32"}
    data = np.load(tmp_path / "step_00000001" / "shard_0.npz")
    assert data["params/embed"].dtype == np.uint16
    assert "error/embed" in data and "opt/step" in data


def _driver(tmp_path, ckpt_dir, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--steps", "10", "--ckpt-every", "5", "--batch", "2",
           "--seq", "32", "--ckpt-dir", str(tmp_path / ckpt_dir),
           "--log-every", "5", *extra]
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=600)


def test_restart_resumes_training(tmp_path):
    """The restart drill: run the driver, stop it at step 6, re-run, and it
    resumes from step 5 with the same data order: its step-10 state equals
    an uninterrupted run's bit for bit (the CPU's sums are deterministic)."""
    r1 = _driver(tmp_path, "ck", "--simulate-failure", "6")
    assert r1.returncode == 42, r1.stderr[-2000:]
    assert "checkpoint ->" in r1.stdout
    assert ckpt.latest_step(str(tmp_path / "ck")) == 5
    r2 = _driver(tmp_path, "ck")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 5" in r2.stdout
    assert "done:" in r2.stdout
    r3 = _driver(tmp_path, "whole")
    assert r3.returncode == 0, r3.stderr[-2000:]
    last = [line for line in r3.stdout.splitlines() if "step 10 loss" in line]
    assert last and last[0].split("(")[0] in r2.stdout
    a = np.load(tmp_path / "ck" / "step_00000010" / "shard_0.npz")
    b = np.load(tmp_path / "whole" / "step_00000010" / "shard_0.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])


def test_driver_without_a_card_raises_before_printing():
    code = ("import sys, torch\n"
            "for m in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "torch.cuda.is_available = lambda: False\n"
            "from repro_torch.launch.train import main\n"
            "try:\n"
            "    main(['--steps', '1'])\n"
            "except RuntimeError as e:\n"
            "    assert 'no CUDA device' in str(e), e\n"
            "    print('raised')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
