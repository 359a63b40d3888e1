"""The port's serving path on the CPU: every case of
``tests/test_serving.py`` (continuous batching must give what the
single-request ``Generator`` gives, whatever the admission order, with the
admit-time and slot-release fixes), the port's greedy ``Generator``
against the JAX package's, and the entry points' refusal to run without a
card unless asked for the CPU.

The port's parameters come from its own ``init_params`` and a
``torch.Generator``, in bf16 as the JAX test's do; the comparison with the
JAX ``Generator`` carries the JAX parameters over in f32, where greedy
tokens can be held equal.
"""

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as r_smoke
from repro.models import build_model as r_build
from repro.models.sharding import init_params as r_init
from repro.serve.serve_step import Generator as RGenerator

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.sharding import init_params
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.serve_step import Generator

from test_torch_cuda import recording, recording_batcher

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama3.2-3b")
    model = build_model(cfg, device="cpu")
    params = init_params(model.specs, torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


class TestContinuousBatching:
    def test_matches_single_request_generation(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
                   for n in (5, 9, 3, 7, 6)]
        gen = Generator(model, params, max_seq=64, device="cpu")
        want = {i: gen.generate(p[None, :], steps=6)[0].tolist()
                for i, p in enumerate(prompts)}
        batcher = ContinuousBatcher(model, params, n_slots=2, max_seq=64)
        rids = [batcher.submit(p, max_new=6) for p in prompts]
        got = batcher.run()
        for i, rid in enumerate(rids):
            assert got[rid] == want[i], f"request {i} diverged"

    def test_slots_recycled(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(1)
        batcher = ContinuousBatcher(model, params, n_slots=2, max_seq=64)
        for _ in range(5):
            batcher.submit(rng.integers(0, cfg.vocab, size=4), max_new=3)
        out = batcher.run()
        assert len(out) == 5
        assert all(len(v) == 3 for v in out.values())
        assert batcher.active() == 0

    def test_ragged_depths_advance_independently(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(2)
        batcher = ContinuousBatcher(model, params, n_slots=3, max_seq=64)
        a = batcher.submit(rng.integers(0, cfg.vocab, size=3), max_new=2)
        b = batcher.submit(rng.integers(0, cfg.vocab, size=12), max_new=8)
        out = batcher.run()
        assert len(out[a]) == 2 and len(out[b]) == 8

    def test_overlong_prompt_rejected_at_submit(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(3)
        batcher = ContinuousBatcher(model, params, n_slots=2, max_seq=16)
        with pytest.raises(ValueError, match="slot capacity"):
            batcher.submit(rng.integers(0, cfg.vocab, size=40), max_new=2)
        with pytest.raises(ValueError, match="slot capacity"):
            batcher.submit(rng.integers(0, cfg.vocab, size=16), max_new=2)
        assert not batcher.queue
        rid = batcher.submit(rng.integers(0, cfg.vocab, size=15), max_new=4)
        out = batcher.run()
        assert 1 <= len(out[rid]) <= 4 and batcher.active() == 0


def _greedy_tokens(model, params, prompt, steps):
    gen = Generator(model, params, max_seq=64, device="cpu")
    return gen.generate(np.asarray(prompt)[None, :], steps=steps)[0].tolist()


def _truncate_at_eos(tokens, eos_id, max_new):
    out = []
    for t in tokens:
        out.append(t)
        if len(out) >= max_new or t == eos_id:
            break
    return out


class TestAdmitTimeCompletion:
    def test_max_new_one_emits_exactly_one_token(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(10)
        prompt = rng.integers(0, cfg.vocab, size=6).astype(np.int32)
        want = _greedy_tokens(model, params, prompt, steps=1)
        batcher = ContinuousBatcher(model, params, n_slots=2, max_seq=64)
        rid = batcher.submit(prompt, max_new=1)
        out = batcher.run()
        assert out[rid] == want and len(out[rid]) == 1
        assert batcher.active() == 0

    def test_eos_first_token_finishes_without_occupying_a_slot(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(11)
        prompt = rng.integers(0, cfg.vocab, size=5).astype(np.int32)
        first = _greedy_tokens(model, params, prompt, steps=1)[0]
        batcher = ContinuousBatcher(model, params, n_slots=2, max_seq=64, eos_id=first)
        rid = batcher.submit(prompt, max_new=8)
        batcher._admit()
        assert batcher.active() == 0
        assert batcher.finished[rid].out == [first]
        assert batcher.run() == {rid: [first]}

    def test_admit_time_finish_frees_the_slot_for_the_queue(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(12)
        p_eos = rng.integers(0, cfg.vocab, size=5).astype(np.int32)
        p_live = rng.integers(0, cfg.vocab, size=7).astype(np.int32)
        eos = _greedy_tokens(model, params, p_eos, steps=1)[0]
        want_live = _truncate_at_eos(
            _greedy_tokens(model, params, p_live, steps=4), eos, 4)
        batcher = ContinuousBatcher(model, params, n_slots=1, max_seq=64, eos_id=eos)
        a = batcher.submit(p_eos, max_new=8)
        b = batcher.submit(p_live, max_new=4)
        out = batcher.run()
        assert out[a] == [eos]
        assert out[b] == want_live


class TestSlotRelease:
    def test_last_tok_zeroed_on_release(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(13)
        batcher = ContinuousBatcher(model, params, n_slots=2, max_seq=64)
        batcher.submit(rng.integers(0, cfg.vocab, size=5), max_new=4)
        batcher.submit(rng.integers(0, cfg.vocab, size=9), max_new=2)
        batcher.run()
        assert batcher.active() == 0
        np.testing.assert_array_equal(batcher.last_tok,
                                      np.zeros_like(batcher.last_tok))
        np.testing.assert_array_equal(batcher.positions,
                                      np.zeros_like(batcher.positions))

    def test_recycled_slot_parity_after_eos_release(self, setup):
        cfg, model, params = setup
        rng = np.random.default_rng(14)
        p_a = rng.integers(0, cfg.vocab, size=6).astype(np.int32)
        p_b = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
        toks_a = _greedy_tokens(model, params, p_a, steps=6)
        eos = toks_a[1]
        want_a = _truncate_at_eos(toks_a, eos, 6)
        want_b = _truncate_at_eos(
            _greedy_tokens(model, params, p_b, steps=5), eos, 5)
        batcher = ContinuousBatcher(model, params, n_slots=1, max_seq=64, eos_id=eos)
        a = batcher.submit(p_a, max_new=6)
        b = batcher.submit(p_b, max_new=5)
        out = batcher.run()
        assert out[a] == want_a
        assert out[b] == want_b
        assert int(batcher.last_tok[0]) == 0


# ---------------------------------------------------------------------------
# beyond the JAX test file: logits, teacher forcing, sampling, JAX parity
# ---------------------------------------------------------------------------

def test_batcher_logits_equal_teacher_forced_generator(setup):
    """The logits that chose each of a request's tokens in the batcher
    equal the Generator's fed the same prompt and tokens (B = 1 against the
    batcher's B = 2 in bf16: 2e-2 of max |logit|, the bf16 bound)."""
    cfg, model, params = setup
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 10, 6)]
    batcher, seen = recording_batcher(model, params, n_slots=2, max_seq=48)
    rids = [batcher.submit(p, max_new=5) for p in prompts]
    batcher.run()
    for rid, p in zip(rids, prompts):
        req = batcher.finished[rid]
        assert len(seen[rid]) == len(req.out) == 5
        assert [int(torch.argmax(lg)) for lg in seen[rid]] == req.out
        logits = []
        Generator(recording(model, logits,
                            forced=np.asarray(req.out[:4])[None, :]),
                  params, max_seq=48, device="cpu").generate(p[None, :],
                                                             steps=4)
        want = torch.stack(logits, dim=1)[0]
        got = torch.stack(seen[rid])
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= 2e-2


def test_temperature_sampling_uses_the_torch_generator(setup):
    cfg, model, params = setup
    prompt = np.arange(6, dtype=np.int32)[None, :]
    gen = Generator(model, params, max_seq=32, device="cpu")
    runs = [gen.generate(prompt, steps=5, temperature=1.0,
                         generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (1, 5)
    assert ((runs[2] >= 0) & (runs[2] < cfg.vocab)).all()
    greedy = gen.generate(prompt, steps=5)
    np.testing.assert_array_equal(
        gen.generate(prompt, steps=5, temperature=0.0,
                     generator=torch.Generator().manual_seed(5)), greedy)


def test_greedy_tokens_equal_jax_generator_in_f32():
    rcfg = r_smoke("llama3.2-3b")
    rmodel = r_build(rcfg)
    rparams = jax.tree.map(lambda a: a.astype(np.float32),
                           r_init(rmodel.specs, jax.random.PRNGKey(0)))
    tmodel = build_model(get_smoke_config("llama3.2-3b"), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(30)
    prompts = rng.integers(0, rcfg.vocab, (3, 9)).astype(np.int32)
    want = RGenerator(rmodel, rparams, max_seq=32).generate(prompts, steps=8)
    got = Generator(tmodel, tparams, max_seq=32, device="cpu").generate(
        prompts, steps=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(model.specs, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    params = init_params(model.specs, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator(model, params)
    assert Generator(model, params, device="cpu").device.type == "cpu"
