"""Typed run configuration + the reference's exact CLI flag surface.

The public API contract (BASELINE.md north star) is the reference's
``run.py`` flags (reference/run.py:8-43) and sweep scripts. This module
keeps that flag surface verbatim and adds framework flags (mesh spec,
resume, profiling, seed grids) behind new names so every reference
invocation is valid here unchanged.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class RunConfig:
    # --- reference flag surface (reference/run.py:8-43) ------------
    name: str = "run"
    num_batches: int = 15000
    num_epochs: int = 10000
    batch_size: int = 100
    learning_rate: float = 1e-4
    padding_dim: int = 0
    overwrite: bool = False
    dataset: str = "4gaussian"  # reference default; errors with a clear message
    layer_sizes: str = "512|512"
    encoder_layer_sizes: str = "512|512"
    latent_dimension: int = 100
    nojit: bool = False
    padding_type: str = "none"
    dataset_seed: int = 69
    state_dict: Optional[str] = None
    data_fn: Optional[str] = None
    warm_start: bool = False
    initialize_inverse: bool = False
    use_fred_covariance: bool = False
    epsilon: float = 0.0
    tunable_decoder_var: bool = False
    dataset_noise: float = 0.0
    dataset_dimension: int = 3
    warm_start_linear: bool = False
    dataset_intrinsic_dimension: int = 3
    latent_off_dimension: int = 1
    # post-parse hardcoded fields (reference/run.py:40-42)
    model: str = "VAE"
    latent_distribution: str = "gaussian"
    tqdm: bool = True

    # --- framework flags (new) -------------------------------------------
    mesh: str = ""  # e.g. "dp=8" or "dp=4,tp=2"; "" = single device
    # Accept a -1 mesh wildcard that leaves devices idle (device count not
    # divisible by the explicit axes). Off by default: idle chips are a
    # silent throughput loss the user must acknowledge.
    mesh_allow_uneven: bool = False
    # Accept tp-requested parameters whose dims aren't divisible by tp
    # training fully REPLICATED (loud stderr note per parameter). Off by
    # default: silently losing the requested tensor parallelism is the same
    # throughput-loss class as idle wildcard chips — it must be explicit.
    tp_allow_replicated: bool = False
    model_seed: int = 0  # reference fixes PRNGKey(0) (reference/model.py:29)
    resume: Optional[str] = None  # checkpoint dir to resume from
    profile: bool = False  # jax.profiler trace of one training chunk
    debug_nans: bool = False  # jax_debug_nans mode
    data_dir: str = "data"  # reference DATA_DIR (reference/utils.py:11)
    checkpoint_every: int = 0  # 0 = only at plot cadence (reference behavior)
    seed_grid: str = ""  # e.g. "2,3,4": all seeds vmapped in ONE launch
    arch: str = "auto"  # auto | mlp | conv (conv for image datasets)
    conv_channels: str = "32|64"  # conv stack widths for --arch conv
    image_source: str = "synthetic"  # synthetic | <path.npz> | <folder>
    image_range: str = "auto"  # auto | 0_255 | 0_1 | pm1 (npz source range)
    image_size: int = 28
    num_images: int = 4096
    # Track (params, grads) at each eval and emit the correlation-ratio
    # landscape diagnostic at the final save. The reference defines the
    # diagnostic but never populates its inputs (vae.py:119,207); off by
    # default for output parity.
    track_correlation: bool = False
    # Multi-host bring-up: call jax.distributed.initialize() before building
    # the mesh, so --mesh axes span hosts (collectives ride the links within
    # a host and the network across hosts). No-op on a single host.
    multihost: bool = False
    # Stat / plot cadences (reference hardcodes 5000/50000 —
    # reference/model.py:123-124; configurable here).
    n_print: int = 5000
    n_plot: int = 50000
    # Checkpoint serialization: npz (numpy only, one file) or orbax
    # (ecosystem-standard tensorstore layout; optional dependency).
    # --resume reads either.
    ckpt_backend: str = "npz"
    # Matmul precision of the model's dots and the dataset samplers'
    # manifold dots. bf16 (the historical name of the default) leaves f32
    # dots at the backend's default precision, which on the H100 lets XLA
    # run them in TF32 (10-bit mantissa operands, f32 accumulation). fp32
    # forces Precision.HIGHEST: true-fp32 matmul arithmetic. Accumulation,
    # ELBO, gradients, Adam, and master weights are f32 in both modes.
    precision: str = "bf16"
    # Adam moment storage dtype. f32 (default) is bitwise-identical to
    # optax.adam / the reference's flax.optim.Adam. bf16 stores the WEIGHT
    # matrices' m/v moments in bfloat16 (compute stays f32; biases/epsilon
    # keep f32 moments), halving the optimizer state. Opt-in because it
    # changes the training trajectory (bf16 rounding of the moments). Must
    # match across --resume (the checkpoint stores the moments in this
    # dtype).
    adam_dtype: str = "f32"

    # --- derived ----------------------------------------------------------
    @property
    def latent_dim(self) -> int:
        return self.latent_dimension

    def validate(self) -> "RunConfig":
        from .data.registry import dataset_names

        if self.dataset not in dataset_names():
            raise ValueError(
                f"--dataset {self.dataset!r} is not available. The reference "
                f"defaulted to '4gaussian' and crashed downstream "
                f"(run.py:18, get_dataset returns None); pass one of "
                f"{dataset_names()}."
            )
        if self.arch not in ("auto", "mlp", "conv"):
            # consumers branch `if arch == "conv" else mlp` — a typo would
            # silently train the wrong architecture without this check
            raise ValueError(f"--arch must be auto|mlp|conv, got {self.arch}")
        if self.ckpt_backend not in ("npz", "orbax"):
            raise ValueError(
                f"--ckpt_backend must be npz|orbax, got {self.ckpt_backend}")
        if self.ckpt_backend == "orbax" and getattr(self, "multihost", False):
            # Orbax's save protocol is COLLECTIVE under jax.distributed
            # (every process must enter StandardCheckpointer.save; its
            # internal barrier waits for the rest), which deadlocks against
            # this engine's process-0-owns-artifacts write discipline —
            # observed as a run that trains forever and never lands a
            # checkpoint. The npz path is the multihost answer: the
            # state is replicated, process 0 writes it whole, every process
            # restores from the shared filesystem (which --resume enforces).
            raise ValueError(
                "--ckpt_backend orbax does not compose with --multihost: "
                "orbax saves are collective across processes while this "
                "engine's artifact writes are process-0-only (a primary-"
                "gated orbax save deadlocks in its cross-process barrier). "
                "Use the default npz backend for multihost runs."
            )
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(
                f"--precision must be fp32|bf16, got {self.precision}")
        if self.adam_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"--adam_dtype must be f32|bf16, got {self.adam_dtype}")
        return self

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="VAE training on JAX/XLA (reference-compatible CLI)"
    )
    # Reference flags — names, defaults, and help mirror run.py:8-43.
    p.add_argument("name", help="The name of the experiment and output directory.")
    p.add_argument("--num_batches", dest="num_batches", type=int, default=15000,
                   help="Number of batches to train on.")
    p.add_argument("--num_epochs", dest="num_epochs", type=int, default=10000)
    p.add_argument("--batch_size", dest="batch_size", type=int, default=100)
    p.add_argument("-lr", "--learning_rate", dest="learning_rate", type=float,
                   default=0.0001)
    p.add_argument("--padding_dim", type=int, dest="padding_dim", default=0)
    p.add_argument("-ow", dest="overwrite", action="store_true")
    p.add_argument("--dataset", dest="dataset", default="4gaussian",
                   choices=["sphere", "linear_gaussian", "sigmoid", "gaussian",
                            "image"])
    p.add_argument("--layer_sizes", dest="layer_sizes", default="512|512",
                   help="Decoder MLP layer sizes as pipe-separated ints, e.g. 512|512; "
                        "empty string = pure linear decoder.")
    p.add_argument("--encoder_layer_sizes", dest="encoder_layer_sizes",
                   default="512|512",
                   help="Encoder MLP layer sizes as pipe-separated ints; "
                        "empty string = pure linear encoder.")
    p.add_argument("--latent_dim", dest="latent_dimension", type=int, default=100)
    p.add_argument("-nojit", dest="nojit", action="store_true",
                   help="Disables just-in-time compilation for step-through "
                        "debugging (every op dispatches individually; best "
                        "with JAX_PLATFORMS=cpu).")
    p.add_argument("--padding_type", dest="padding_type", default="none",
                   choices=["zero", "gaussian", "none"])
    p.add_argument("-ds", "--dataset_seed", dest="dataset_seed", type=int, default=69)
    p.add_argument("--state_dict", dest="state_dict", default=None)
    p.add_argument("--data_fn", dest="data_fn", default=None)
    p.add_argument("-ws", "--warm_start", action="store_true")
    p.add_argument("-ii", "--initialize_inverse", action="store_true")
    p.add_argument("-ufc", "--use_fred_covariance", action="store_true")
    p.add_argument("-e", "--epsilon", type=float, default=0.0)
    p.add_argument("-tdv", dest="tunable_decoder_var", action="store_true")
    p.add_argument("-dn", "--dataset_noise", type=float, default=0.0)
    p.add_argument("-dd", "--dataset_dimension", type=int, default=3)
    p.add_argument("-wsl", "--warm_start_linear", action="store_true")
    p.add_argument("-did", "--dataset_intrinsic_dimension", type=int, default=3)
    p.add_argument("-off", "--latent_off_dimension", type=int, default=1)
    # Framework flags (new).
    p.add_argument("--mesh", dest="mesh", default="",
                   help="Device mesh spec, e.g. 'dp=8' or 'dp=4,tp=2'. "
                        "Empty = single device.")
    p.add_argument("--mesh_allow_uneven", dest="mesh_allow_uneven",
                   action="store_true",
                   help="Allow a -1 mesh wildcard to leave devices idle "
                        "when the device count is not divisible by the "
                        "explicit axes (default: error).")
    p.add_argument("--tp_allow_replicated", dest="tp_allow_replicated",
                   action="store_true",
                   help="Allow parameters whose dims are not divisible by "
                        "the tp mesh axis to train fully replicated (loud "
                        "per-parameter stderr note; default: error).")
    p.add_argument("--model_seed", dest="model_seed", type=int, default=0)
    p.add_argument("--resume", dest="resume", default=None,
                   help="Checkpoint directory to resume training from. With "
                        "--seed_grid, any non-empty value resumes every row "
                        "from its own <name>_seed<N>/ checkpoint.")
    p.add_argument("--profile", dest="profile", action="store_true",
                   help="Capture a jax.profiler trace of one training chunk.")
    p.add_argument("--debug_nans", dest="debug_nans", action="store_true")
    p.add_argument("--data_dir", dest="data_dir", default="data")
    p.add_argument("--checkpoint_every", dest="checkpoint_every", type=int, default=0)
    p.add_argument("--seed_grid", dest="seed_grid", default="",
                   help="Comma-separated dataset seeds, e.g. '2,3,4': trains "
                        "every seed simultaneously in one vmapped device "
                        "program; outputs land in <name>_seed<N>/.")
    p.add_argument("--arch", dest="arch", default="auto",
                   choices=["auto", "mlp", "conv"],
                   help="Network architecture; auto = conv for image "
                        "datasets, mlp otherwise.")
    p.add_argument("--conv_channels", dest="conv_channels", default="32|64")
    p.add_argument("--image_source", dest="image_source", default="synthetic",
                   help="'synthetic' or a path to an .npz / image folder.")
    p.add_argument("--image_range", dest="image_range", default="auto",
                   choices=["auto", "0_255", "0_1", "pm1"],
                   help="Pixel range of an .npz corpus (auto = npz "
                        "pixel_range metadata, else heuristic).")
    p.add_argument("--image_size", dest="image_size", type=int, default=28)
    p.add_argument("--num_images", dest="num_images", type=int, default=4096)
    p.add_argument("--track_correlation", dest="track_correlation",
                   action="store_true",
                   help="Record (params, grads) each eval and emit the "
                        "correlation-ratio diagnostic at the final save.")
    p.add_argument("--multihost", dest="multihost", action="store_true",
                   help="Initialize jax.distributed before building the "
                        "mesh (multi-host runs; coordinator from "
                        "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                        "JAX_PROCESS_ID).")
    p.add_argument("--n_print", dest="n_print", type=int, default=5000,
                   help="Stat cadence in steps (reference: 5000).")
    p.add_argument("--n_plot", dest="n_plot", type=int, default=50000,
                   help="Plot/save cadence in steps (reference: 50000).")
    p.add_argument("--ckpt_backend", dest="ckpt_backend", default="npz",
                   choices=["npz", "orbax"],
                   help="Checkpoint format; --resume auto-detects either.")
    p.add_argument("--precision", dest="precision", default="bf16",
                   choices=["bf16", "fp32"],
                   help="Matmul precision. bf16 (default) keeps the "
                        "backend's default for float32 dots, which on the "
                        "H100 may run them in TF32. fp32 forces true-fp32 "
                        "matmuls (Precision.HIGHEST) for reference-exact "
                        "arithmetic.")
    p.add_argument("--adam_dtype", dest="adam_dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="Adam moment storage: f32 (default, bitwise optax) "
                        "or bf16 weight-matrix moments (f32 compute; halves "
                        "the optimizer state; changes the trajectory by "
                        "moment rounding). Must match across --resume.")
    return p


def parse_arguments(argv=None) -> RunConfig:
    args = build_parser().parse_args(argv)
    cfg = RunConfig(**vars(args))
    # Post-parse hardcoded fields, mirroring reference/run.py:40-42.
    cfg.model = "VAE"
    cfg.latent_distribution = "gaussian"
    cfg.tqdm = True
    return cfg
