"""Checkpoint/resume bit-exactness and model.pkl export round-trip.

Resume determinism is a design property: per-step keys derive from
fold_in(base_key, step), so a resumed run consumes the identical random
stream as an uninterrupted one — the state after 100+100 steps equals the
state after 200 straight steps, bit for bit.
"""

import os
import pickle

import jax
import numpy as np
import pytest

from vae_training_tpu.config import RunConfig
from vae_training_tpu.data import get_dataset
from vae_training_tpu.runio import (
    make_output_dir,
    restore_checkpoint,
    save_checkpoint,
)
from vae_training_tpu.runio.export import load_model_pkl, save_model_pkl
from vae_training_tpu.train import Trainer


def build(tmpdir, name="ck", **kw):
    defaults = dict(
        name=name,
        dataset="linear_gaussian",
        encoder_layer_sizes="",
        layer_sizes="",
        latent_dimension=6,
        padding_dim=3,
        dataset_dimension=3,
        num_batches=200,
        batch_size=50,
        learning_rate=1e-3,
        epsilon=-1.0,
        tunable_decoder_var=True,
        dataset_seed=2,
        overwrite=True,
        tqdm=False,
        data_dir=tmpdir,
    )
    defaults.update(kw)
    cfg = RunConfig(**defaults).validate()
    out = make_output_dir(cfg.name, cfg.overwrite, cfg, data_dir=cfg.data_dir)
    ds = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    return Trainer(cfg, ds, out), out, cfg


def tree_equal(a, b):
    eq = jax.tree_util.tree_map(
        lambda x, y: bool(np.array_equal(np.asarray(x), np.asarray(y))), a, b
    )
    return all(jax.tree_util.tree_leaves(eq))


@pytest.mark.slow  # e2e resume invariant — full-gate coverage
def test_resume_is_bit_exact(tmp_outdir):
    straight, _, _ = build(tmp_outdir, "a")
    straight.state, _ = straight.fns.train_chunk(straight.state, 200)

    half, out, _ = build(tmp_outdir, "b")
    half.state, _ = half.fns.train_chunk(half.state, 100)
    save_checkpoint(out, half.state)

    resumed, _, _ = build(tmp_outdir, "c", resume=out)
    assert int(resumed.state.step) == 100
    resumed.state, _ = resumed.fns.train_chunk(resumed.state, 100)

    assert tree_equal(straight.state.params, resumed.state.params)
    assert tree_equal(straight.state.opt_state, resumed.state.opt_state)
    assert int(resumed.state.step) == 200


@pytest.mark.slow  # e2e resume invariant — full-gate coverage
def test_resume_is_bit_exact_bf16_moments(tmp_outdir):
    """--adam_dtype bf16: the bfloat16 moment buffers must survive the
    checkpoint round-trip with their dtype AND bits (moments round to bf16
    every step, so 100+100 == 200 exactly, same as f32)."""
    import jax.numpy as jnp

    from vae_training_tpu.train.state import adam_state

    straight, _, _ = build(tmp_outdir, "a16", adam_dtype="bf16")
    straight.state, _ = straight.fns.train_chunk(straight.state, 200)

    half, out, _ = build(tmp_outdir, "b16", adam_dtype="bf16")
    half.state, _ = half.fns.train_chunk(half.state, 100)
    save_checkpoint(out, half.state)

    resumed, _, _ = build(tmp_outdir, "c16", resume=out, adam_dtype="bf16")
    assert int(resumed.state.step) == 100
    ra = adam_state(resumed.state.opt_state)
    assert ra.mu["Encoder"]["FC0"]["kernel"].dtype == jnp.bfloat16
    assert ra.mu["Encoder"]["FC0"]["bias"].dtype == jnp.float32
    resumed.state, _ = resumed.fns.train_chunk(resumed.state, 100)

    assert tree_equal(straight.state.params, resumed.state.params)
    assert tree_equal(straight.state.opt_state, resumed.state.opt_state)


def test_model_pkl_layout_and_roundtrip(tmp_outdir):
    trainer, out, _ = build(tmp_outdir, "pkl")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 50)
    path = os.path.join(out, "model.pkl")
    save_model_pkl(path, jax.device_get(trainer.state.params),
                   jax.device_get(trainer.state.opt_state))

    with open(path, "rb") as f:
        sd = pickle.load(f)
    # Reference optimizer-state-dict layout (reference/model.py:85-89);
    # target is the RAW param tree — the reference's pre-Linen model serializes
    # without a "params" wrapper (the reference indexes
    # initial_params['Decoder'] directly, vae.py:87-105)
    assert set(sd) == {"target", "state"}
    assert set(sd["target"]) >= {"Encoder", "Decoder", "epsilon_p"}
    assert sd["state"]["step"] == 50
    ps = sd["state"]["param_states"]
    any_leaf = ps["Encoder"]["FC0"]["kernel"]
    assert set(any_leaf) == {"grad_ema", "grad_sq_ema"}

    # Round-trip through --state_dict restore
    fresh, _, _ = build(tmp_outdir, "pkl2")
    params, opt_state = load_model_pkl(path, fresh.state.params,
                                       fresh.state.opt_state)
    assert tree_equal(params, trainer.state.params)
    # Adam moments restored
    import optax
    def moments(s):
        for x in jax.tree_util.tree_leaves(
            s, is_leaf=lambda y: isinstance(y, optax.ScaleByAdamState)):
            if isinstance(x, optax.ScaleByAdamState):
                return x
    m0, m1 = moments(trainer.state.opt_state), moments(opt_state)
    assert tree_equal(m0.mu, m1.mu) and tree_equal(m0.nu, m1.nu)
    assert int(m1.count) == 50


@pytest.mark.slow  # reliability e2e — full-gate coverage
def test_state_dict_flag_resumes_params(tmp_outdir):
    trainer, out, _ = build(tmp_outdir, "sd1")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 30)
    path = os.path.join(out, "model.pkl")
    save_model_pkl(path, jax.device_get(trainer.state.params),
                   jax.device_get(trainer.state.opt_state))
    resumed, _, _ = build(tmp_outdir, "sd2", state_dict=path)
    assert tree_equal(resumed.state.params, trainer.state.params)


def test_checkpoint_never_replaced_by_older(tmp_outdir):
    """A queued async save must not clobber a newer sync checkpoint."""
    trainer, out, _ = build(tmp_outdir, "order")
    old_state = jax.device_get(trainer.state)  # host snapshot at step 0
    # (snapshot BEFORE the chunk: train_chunk donates its input buffers)
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 20)
    save_checkpoint(out, trainer.state)  # step 20
    save_checkpoint(out, old_state)  # stale write attempt
    restored = restore_checkpoint(out, trainer.state)
    assert int(restored.step) == 20  # newer checkpoint survived


@pytest.mark.slow  # heaviest e2e in the file (~1 min on 1 core)
def test_resume_artifacts_equal_uninterrupted(tmp_outdir):
    """A preempted + resumed run must emit a losses.npz IDENTICAL to an
    uninterrupted run's: checkpoints carry the full host-side run state
    (StatsRecorder history, eval-key counter, host key chain), not just the
    TrainState (ref artifact contract: reference/model.py:246-252)."""
    from vae_training_tpu.runio.checkpoint import wait_for_pending_saves

    def drive(trainer):
        trainer.n_print = 100
        trainer.n_plot = 200
        trainer.train()
        trainer.plot()
        trainer.save(final=True)

    # Uninterrupted run: 400 steps straight through.
    straight, out_a, _ = build(tmp_outdir, "full", num_batches=400)
    drive(straight)

    # Preempted run: the --checkpoint_every async save lands at step 200
    # (between chunks, BEFORE that step's events), then the process dies
    # mid-event at step 200 — the eval it just appended is post-snapshot
    # and must be replayed by the resume.
    pre, out_b, cfg_b = build(tmp_outdir, "pre", num_batches=400,
                              checkpoint_every=150)
    pre.n_print = 100
    pre.n_plot = 200
    orig_plot = pre.plot_epoch

    def dying_plot():
        if pre.batchnum == 200:
            raise KeyboardInterrupt
        orig_plot()

    pre.plot_epoch = dying_plot
    import pytest as _pytest
    with _pytest.raises(KeyboardInterrupt):
        pre.train()
    wait_for_pending_saves()
    import json
    meta = json.load(open(os.path.join(out_b, "ckpt_meta.json")))
    assert meta["step"] == 200  # the --checkpoint_every async save landed

    # Resume INTO THE SAME output dir (what a restarted job does) and finish.
    cfg_b.resume = out_b
    from vae_training_tpu.data import get_dataset as _get_dataset
    ds = _get_dataset(cfg_b.dataset, cfg_b.dataset_seed, cfg_b)
    resumed = Trainer(cfg_b, ds, out_b)
    assert int(resumed.state.step) == 200
    drive(resumed)

    za = np.load(os.path.join(out_a, "losses.npz"), allow_pickle=True)
    zb = np.load(os.path.join(out_b, "losses.npz"), allow_pickle=True)
    assert set(za.files) == set(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(np.asarray(za[k], dtype=np.float64),
                                      np.asarray(zb[k], dtype=np.float64),
                                      err_msg=k)
    # and the final model artifacts agree bit for bit
    ra = restore_checkpoint(out_a, jax.device_get(straight.state))
    rb = restore_checkpoint(out_b, jax.device_get(straight.state))
    assert tree_equal(ra.params, rb.params)
    assert int(ra.step) == int(rb.step) == 400


def test_make_output_dir_reuse_existing(tmp_outdir):
    from vae_training_tpu.config import RunConfig
    from vae_training_tpu.runio import make_output_dir

    cfg = RunConfig(name="ruse", data_dir=tmp_outdir)
    out = make_output_dir("ruse", False, cfg, data_dir=tmp_outdir)
    marker = os.path.join(out, "keep.me")
    open(marker, "w").write("x")
    # reuse keeps artifacts and refreshes the manifest without clobbering
    out2 = make_output_dir("ruse", False, cfg, data_dir=tmp_outdir,
                           reuse_existing=True)
    assert out2 == out and os.path.exists(marker)


@pytest.mark.slow  # reliability e2e — full-gate coverage
def test_mixed_backends_restore_newest(tmp_outdir):
    """A newer orbax sync save must win over an older npz async save
    (and vice versa): restore follows the meta's backend, and the
    step-ordering guard holds across backends."""
    from vae_training_tpu.runio.checkpoint import (
        save_checkpoint_async,
        save_checkpoint_orbax,
    )

    trainer, out, _ = build(tmp_outdir, "mix")
    old_state = jax.device_get(trainer.state)  # step 0 snapshot
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 20)
    # async npz save at step 20 (simulating --checkpoint_every) ...
    save_checkpoint_async(out, trainer.state, backend="npz").result()
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 20)
    # ... then a newer orbax sync save at step 40 (--ckpt_backend orbax)
    save_checkpoint_orbax(out, trainer.state)
    # a stale queued npz write must be refused across backends
    save_checkpoint(out, old_state)
    restored = restore_checkpoint(out, jax.device_get(trainer.state))
    assert int(restored.step) == 40
    assert tree_equal(restored.params, jax.device_get(trainer.state.params))
    # and a stale queued ORBAX write must be refused too
    save_checkpoint_orbax(out, old_state)
    restored = restore_checkpoint(out, jax.device_get(trainer.state))
    assert int(restored.step) == 40


def test_async_save_honors_backend(tmp_outdir):
    """save_checkpoint_async(backend='orbax') writes orbax, not npz."""
    from vae_training_tpu.runio.checkpoint import (
        ORBAX_NAME,
        save_checkpoint_async,
    )

    trainer, out, _ = build(tmp_outdir, "asyb")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 10)
    save_checkpoint_async(out, trainer.state, backend="orbax").result()
    assert os.path.exists(os.path.join(out, ORBAX_NAME))
    assert not os.path.exists(os.path.join(out, "ckpt.npz"))
    restored = restore_checkpoint(out, jax.device_get(trainer.state))
    assert int(restored.step) == 10


def test_orbax_backend_roundtrip(tmp_outdir):
    """--ckpt_backend orbax: save via orbax, --resume auto-detects it."""
    from vae_training_tpu.runio.checkpoint import (
        checkpoint_exists,
        save_checkpoint_orbax,
    )

    trainer, out, cfg = build(tmp_outdir, "orb", ckpt_backend="orbax")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 40)
    save_checkpoint_orbax(out, trainer.state,
                          extra_meta={"current_epsilon": -2.5})
    assert checkpoint_exists(out)
    assert not os.path.exists(os.path.join(out, "ckpt.npz"))

    resumed, _, _ = build(tmp_outdir, "orb2", resume=out)
    assert int(resumed.state.step) == 40
    assert float(np.asarray(resumed.current_epsilon)) == -2.5
    assert tree_equal(resumed.state.params, trainer.state.params)

@pytest.mark.slow  # reliability e2e — full-gate coverage
def test_orbax_swap_is_preemption_safe(tmp_outdir):
    """A kill between the orbax swap's two renames leaves the set-aside
    .old directory; restore and checkpoint_exists must still see it."""
    import shutil

    from vae_training_tpu.runio.checkpoint import (
        ORBAX_NAME,
        checkpoint_exists,
        save_checkpoint_orbax,
    )

    trainer, out, _ = build(tmp_outdir, "orbswap", ckpt_backend="orbax")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 7)
    save_checkpoint_orbax(out, trainer.state)
    path = os.path.join(out, ORBAX_NAME)
    # simulate preemption mid-swap: old renamed aside, new not yet installed
    os.replace(path, path + ".old")
    assert checkpoint_exists(out)
    restored = restore_checkpoint(out, jax.device_get(trainer.state))
    assert int(restored.step) == 7
    # a later save must clean the leftover and reinstall normally
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 1)
    save_checkpoint_orbax(out, trainer.state)
    assert os.path.exists(path) and not os.path.exists(path + ".old")
    restored = restore_checkpoint(out, jax.device_get(trainer.state))
    assert int(restored.step) == 8


def test_async_save_failure_surfaces(tmp_outdir):
    """A failed background save must raise on the next async save (or
    wait_for_pending_saves), not silently disable checkpointing."""
    import pytest

    from vae_training_tpu.runio import checkpoint as ck

    trainer, out, _ = build(tmp_outdir, "asyfail")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 3)
    missing = os.path.join(out, "no_such_dir", "deeper")
    fut = ck.save_checkpoint_async(missing, trainer.state)
    with pytest.raises(Exception):
        fut.result()  # the write itself failed (ENOENT)
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        ck.wait_for_pending_saves()
    # error is cleared after being surfaced; saves work again
    ck.save_checkpoint_async(out, trainer.state).result()
    ck.wait_for_pending_saves()
    restored = restore_checkpoint(out, jax.device_get(trainer.state))
    assert int(restored.step) == 3

def test_load_model_pkl_accepts_legacy_wrapped_target(tmp_outdir):
    """Pre-round-2 exports wrapped target in {"params": ...}; load still
    accepts them alongside the reference's raw-tree layout."""
    trainer, out, _ = build(tmp_outdir, "pklw")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 5)
    path = os.path.join(out, "model.pkl")
    save_model_pkl(path, jax.device_get(trainer.state.params),
                   jax.device_get(trainer.state.opt_state))
    with open(path, "rb") as f:
        sd = pickle.load(f)
    sd["target"] = {"params": sd["target"]}
    with open(path, "wb") as f:
        pickle.dump(sd, f)
    fresh, _, _ = build(tmp_outdir, "pklw2")
    params, _ = load_model_pkl(path, fresh.state.params,
                               fresh.state.opt_state)
    assert tree_equal(params, trainer.state.params)

def test_stale_async_save_after_newer_sync_save(tmp_outdir):
    """The REAL preemption ordering: a queued --checkpoint_every async save
    whose background write lands AFTER a newer sync save must not clobber
    it. Previous tests serialized every async save with .result(), so the
    step-ordering guard was never exercised with a genuinely pending
    write; here a blocker task holds the single writer thread until the
    newer sync checkpoint is already on disk."""
    import threading

    from vae_training_tpu.runio import checkpoint as ck

    trainer, out, _ = build(tmp_outdir, "race")
    old_state = jax.device_get(trainer.state)  # step 0 snapshot
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 25)

    gate = threading.Event()
    blocker = ck._executor().submit(gate.wait)  # parks the writer thread
    stale = ck.save_checkpoint_async(out, old_state)  # queued behind it
    save_checkpoint(out, trainer.state)  # newer sync save lands NOW
    gate.set()
    blocker.result()
    stale.result()  # the stale write runs after — guard must drop it
    ck.wait_for_pending_saves()

    restored = restore_checkpoint(out, jax.device_get(trainer.state))
    assert int(restored.step) == 25
    import json
    meta = json.load(open(os.path.join(out, "ckpt_meta.json")))
    assert meta["step"] == 25


@pytest.mark.slow  # reliability e2e — full-gate coverage
def test_orbax_old_promoted_not_deleted_before_new_save(tmp_outdir):
    """ADVICE r2: when only the set-aside .old survives a mid-swap
    preemption, the next save must PROMOTE it back to `path` before
    writing — never rmtree the only copy. A second failure during the
    (multi-second) ckptr.save window must still leave a restorable
    checkpoint."""
    import orbax.checkpoint as ocp
    import pytest

    from vae_training_tpu.runio.checkpoint import (
        ORBAX_NAME,
        checkpoint_exists,
        save_checkpoint_orbax,
    )

    trainer, out, _ = build(tmp_outdir, "orbpromote", ckpt_backend="orbax")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 5)
    save_checkpoint_orbax(out, trainer.state)
    path = os.path.join(out, ORBAX_NAME)
    # preemption mid-swap: only .old survives
    os.replace(path, path + ".old")

    # second preemption: the new save dies inside ckptr.save
    real_save = ocp.StandardCheckpointer.save
    try:
        ocp.StandardCheckpointer.save = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("preempted during save"))
        trainer.state, _ = trainer.fns.train_chunk(trainer.state, 1)
        with pytest.raises(RuntimeError, match="preempted"):
            save_checkpoint_orbax(out, trainer.state)
    finally:
        ocp.StandardCheckpointer.save = real_save

    # the step-5 checkpoint must have survived (promoted to `path`)
    assert checkpoint_exists(out)
    restored = restore_checkpoint(out, jax.device_get(trainer.state))
    assert int(restored.step) == 5


def test_checkpoint_retention_keeps_prev(tmp_outdir):
    """Each npz save sets the previous {ckpt, aux, meta} trio aside as
    .prev (grid rollback depends on it); a same-step re-save must not
    clobber a meaningful .prev with a duplicate."""
    from vae_training_tpu.runio.checkpoint import (
        read_checkpoint_meta,
        restore_checkpoint_aux,
        restore_checkpoint_prev,
    )

    trainer, out, _ = build(tmp_outdir, "ret")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 10)
    s10 = jax.device_get(trainer.state)
    save_checkpoint(out, trainer.state, aux={"tag": 10})
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 10)
    save_checkpoint(out, trainer.state, aux={"tag": 20})

    assert read_checkpoint_meta(out)["step"] == 20
    assert read_checkpoint_meta(out, prev=True)["step"] == 10
    prev = restore_checkpoint_prev(out, s10)
    assert int(prev.step) == 10
    assert tree_equal(prev.params, s10.params)
    assert restore_checkpoint_aux(out, prev=True)["tag"] == 10
    assert restore_checkpoint_aux(out)["tag"] == 20

    # same-step re-save: current updates, .prev untouched
    save_checkpoint(out, trainer.state, aux={"tag": 21})
    assert read_checkpoint_meta(out, prev=True)["step"] == 10
    assert restore_checkpoint_aux(out, prev=True)["tag"] == 10
    assert restore_checkpoint_aux(out)["tag"] == 21


def test_restore_falls_back_to_prev_when_current_missing(tmp_outdir):
    """A kill between the retention set-aside and the install leaves only
    the .prev trio; restore_checkpoint and checkpoint_exists must honor it."""
    from vae_training_tpu.runio.checkpoint import (
        CKPT_NAME,
        META_NAME,
        checkpoint_exists,
    )

    trainer, out, _ = build(tmp_outdir, "retk")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 10)
    s10 = jax.device_get(trainer.state)
    save_checkpoint(out, trainer.state)
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 10)
    save_checkpoint(out, trainer.state)

    os.remove(os.path.join(out, CKPT_NAME))
    os.remove(os.path.join(out, META_NAME))
    assert checkpoint_exists(out)
    got = restore_checkpoint(out, s10)
    assert int(got.step) == 10
    assert tree_equal(got.params, s10.params)


def test_promote_prev_checkpoint_installs_prev(tmp_outdir):
    """Grid rollback's promotion: the .prev trio becomes CURRENT, so the
    save ordering guard no longer sees the discarded newer step."""
    from vae_training_tpu.runio.checkpoint import (
        promote_prev_checkpoint,
        read_checkpoint_meta,
        restore_checkpoint_aux,
    )

    trainer, out, _ = build(tmp_outdir, "prom")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 10)
    s10 = jax.device_get(trainer.state)
    save_checkpoint(out, trainer.state, aux={"tag": 10})
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 10)
    save_checkpoint(out, trainer.state, aux={"tag": 20})

    promote_prev_checkpoint(out)
    assert read_checkpoint_meta(out)["step"] == 10
    assert restore_checkpoint_aux(out)["tag"] == 10
    got = restore_checkpoint(out, s10)
    assert int(got.step) == 10
    # a post-rollback save at a step below the discarded 20 must land
    save_checkpoint(out, trainer.state.replace(step=15))
    assert read_checkpoint_meta(out)["step"] == 15


def test_npz_checkpoint_keeps_bf16_moments(tmp_outdir):
    """The npz format stores bfloat16 leaves (--adam_dtype bf16 moments)
    by their bit patterns: dtype and bits survive the round trip."""
    import jax.numpy as jnp

    from vae_training_tpu.train.state import adam_state

    trainer, out, _ = build(tmp_outdir, "bf16npz", adam_dtype="bf16")
    trainer.state, _ = trainer.fns.train_chunk(trainer.state, 5)
    save_checkpoint(out, trainer.state)
    got = restore_checkpoint(out, jax.device_get(trainer.state))
    assert adam_state(got.opt_state).mu["Encoder"]["FC0"]["kernel"].dtype \
        == jnp.bfloat16
    assert tree_equal(got.opt_state, trainer.state.opt_state)
    assert tree_equal(got.params, trainer.state.params)


def test_npz_checkpoint_rejects_other_configuration(tmp_outdir):
    """Restoring into a template of another model or optimizer layout is
    a clear error naming the leaf, never a silent partial restore."""
    trainer, out, _ = build(tmp_outdir, "small")
    save_checkpoint(out, trainer.state)
    other, _, _ = build(tmp_outdir, "wide", latent_dimension=8)
    with pytest.raises(ValueError, match="leaf"):
        restore_checkpoint(out, jax.device_get(other.state))
    bf16, _, _ = build(tmp_outdir, "bf16tmpl", adam_dtype="bf16")
    with pytest.raises(ValueError, match="expected bfloat16"):
        restore_checkpoint(out, jax.device_get(bf16.state))
