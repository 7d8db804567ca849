"""CLI surface tests: flag parity with the reference, sweep-row parsing,
end-to-end tiny runs per dataset."""

import json
import os

import numpy as np
import pytest

from vae_training_tpu.config import parse_arguments


def test_reference_sweep_row_parses():
    # Row 1 of reference/seed_linpadding_expts.sh
    argv = [
        "vae3linear_gaussian_12dim2", "--dataset", "linear_gaussian",
        "--encoder_layer_sizes", "", "--layer_sizes", "", "-ow",
        "--latent_dim", "20", "--padding_dim", "9", "-dd", "3",
        "--num_batches", "100000", "--epsilon", "-1", "-tdv",
        "-ds", "2", "-lr", "1e-3",
    ]
    cfg = parse_arguments(argv)
    assert cfg.name == "vae3linear_gaussian_12dim2"
    assert cfg.dataset == "linear_gaussian"
    assert cfg.encoder_layer_sizes == "" and cfg.layer_sizes == ""
    assert cfg.latent_dimension == 20 and cfg.padding_dim == 9
    assert cfg.dataset_dimension == 3 and cfg.num_batches == 100000
    assert cfg.epsilon == -1.0 and cfg.tunable_decoder_var
    assert cfg.dataset_seed == 2 and cfg.learning_rate == 1e-3
    assert cfg.model == "VAE" and cfg.latent_distribution == "gaussian"


def test_sphere_sweep_row_parses():
    argv = (
        "sphere_dd3_pd3_ld_6_eps-3 --dataset sphere "
        "--encoder_layer_sizes 200|200|200 --layer_sizes 200|200|200 -ow "
        "--latent_dim 6 --padding_dim 3 -dd 3 --num_batches 150000 "
        "--epsilon -3 -tdv"
    ).split()
    cfg = parse_arguments(argv)
    assert cfg.encoder_layer_sizes == "200|200|200"
    assert cfg.epsilon == -3.0


def test_default_dataset_errors_clearly():
    cfg = parse_arguments(["x"])
    with pytest.raises(ValueError, match="4gaussian"):
        cfg.validate()


@pytest.mark.parametrize(
    "dataset,extra",
    [
        ("linear_gaussian", ["--latent_dim", "6", "-tdv", "--epsilon", "-1"]),
        ("sigmoid", ["--latent_dim", "6", "-tdv", "--epsilon", "-3"]),
        ("sphere", ["--latent_dim", "4", "--encoder_layer_sizes", "16",
                    "--layer_sizes", "16", "--epsilon", "-3", "-tdv"]),
        ("gaussian", ["--latent_dim", "4"]),
    ],
)
def test_end_to_end_tiny_run(tmp_outdir, dataset, extra):
    from run import main

    argv = [
        f"e2e_{dataset}", "--dataset", dataset, "--num_batches", "60",
        "--batch_size", "20", "--padding_dim", "2", "-dd", "3", "-ow",
        "--encoder_layer_sizes", "", "--layer_sizes", "",
        "--data_dir", tmp_outdir,
    ] + extra
    cfg = parse_arguments(argv)
    assert main(cfg) == 0
    out = os.path.join(tmp_outdir, f"e2e_{dataset}")
    files = set(os.listdir(out))
    assert {"args.json", "losses.npz", "model.pkl", "ckpt.npz"} <= files
    with open(os.path.join(out, "args.json")) as f:
        manifest = json.load(f)
    assert manifest["dataset"] == dataset
    z = np.load(os.path.join(out, "losses.npz"), allow_pickle=True)
    assert z["VAE Loss"].shape[0] >= 60
    assert np.all(np.isfinite(z["VAE Loss"]))


def test_overwrite_protection(tmp_outdir):
    from vae_training_tpu.config import RunConfig
    from vae_training_tpu.runio import make_output_dir

    cfg = RunConfig(name="dup", data_dir=tmp_outdir)
    make_output_dir("dup", False, cfg, data_dir=tmp_outdir)
    with pytest.raises(ValueError, match="already exists"):
        make_output_dir("dup", False, cfg, data_dir=tmp_outdir)
    # -ow clears recursively, including subdirectories (reference crashed)
    os.makedirs(os.path.join(tmp_outdir, "dup", "sub"), exist_ok=True)
    make_output_dir("dup", True, cfg, data_dir=tmp_outdir)
    assert os.listdir(os.path.join(tmp_outdir, "dup")) == ["args.json"]

def test_resume_clobber_guards(tmp_outdir):
    """--resume only bypasses clobber protection when resuming IN PLACE;
    a foreign resume into an existing name needs -ow, and -ow is refused
    when it would wipe the resume source itself."""
    from run import main

    def argv(name, *extra):
        return parse_arguments([
            name, "--dataset", "linear_gaussian", "--num_batches", "40",
            "--batch_size", "20", "--padding_dim", "2", "-dd", "3",
            "--encoder_layer_sizes", "", "--layer_sizes", "",
            "--data_dir", tmp_outdir, *extra,
        ])

    assert main(argv("src", "-ow")) == 0
    src = os.path.join(tmp_outdir, "src")
    assert main(argv("dst", "-ow")) == 0

    # foreign resume into the existing dst without -ow → clobber error
    with pytest.raises(ValueError, match="already exists"):
        main(argv("dst", "--resume", src))
    # in-place resume (same dir, even without -ow) is allowed
    assert main(argv("src", "--resume", src, "--num_batches", "60")) == 0
    # in-place through a symlinked data path still counts as in-place
    link = tmp_outdir + "_link"
    if not os.path.exists(link):
        os.symlink(tmp_outdir, link)
    assert main(argv("src", "--resume", os.path.join(link, "src"),
                     "--num_batches", "80")) == 0
    # -ow that would wipe the resume source (a subpath) is refused
    with pytest.raises(ValueError, match="lies inside"):
        main(argv("src", "-ow", "--resume", os.path.join(src, "sub")))

def test_parser_defaults_match_dataclass_defaults():
    """The flag surface has two declarations (RunConfig fields and argparse
    defaults); this pins them together so a default changed in one place
    can't silently diverge CLI runs from programmatic RunConfig() users
    (sweep.py, bench.py, tests)."""
    import dataclasses

    from vae_training_tpu.config import RunConfig, build_parser

    fields = {f.name: f for f in dataclasses.fields(RunConfig)}
    p = build_parser()
    checked = 0
    for action in p._actions:
        if action.dest in ("help", "name") or action.dest not in fields:
            continue
        f = fields[action.dest]
        expected = (f.default if f.default is not dataclasses.MISSING
                    else f.default_factory())
        assert action.default == expected, (
            f"--{action.dest}: parser default {action.default!r} != "
            f"RunConfig default {expected!r}")
        checked += 1
    assert checked >= 25  # the shared surface really was compared
