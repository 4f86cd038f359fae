"""One rank of the port's multi-rank checks on the CPU (gloo).

    python tests/torch_dist_worker.py RANK STORE OUT_DIR MESH

MESH is data2, fsdp2 or data2xfsdp2 (its ranks: 2, 2 or 4 processes, one
file store). Every process runs every scenario, each on a fresh engine
wrapped with FSDP2 over the mesh, and rank 0 holds each one against the
port's one-process run of the same global batch, which it computes itself.
Rank 0 writes ``OUT_DIR/MESH.json``: for each scenario, each quantity's
worst error as a share of its tolerance (``|got - want| / (atol + rtol ·
|want|)``, at most 1 passes), so that each check is a test case of its own
in ``tests/test_torch_distributed.py``. The fsdp-2 mesh also runs the step
held against JAX's mesh step there (``jax_step``, from the inputs that file
writes to ``OUT_DIR/jax_inputs.npz``), the data-2 mesh the CLI's ``fit``
(``cli_fit``), which that file holds against the one-process fit that rank
0 of the data-2 mesh runs first (``cli_one``).

Sequence parallelism: the data-2 and the 4-rank sets run the ring
(``ring_check``, over all their ranks: n = 2 and 4), forward and q/k/v
gradients held against the port's plain attention on the whole sequence
and written for the test to hold against JAX's ``ring_attention_sharded``;
the fsdp-2 set runs the CLI's ``fit`` with ``context_parallel: 2`` and the
4-rank set with fsdp 2 x context 2, both with the UNet's blocks
checkpointed (the ring recomputed in the backward), held by the test
against the one-process fit of the same config that rank 0 of the fsdp-2
set runs first (``cli_one_remat``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# tolerances: (atol, rtol)
F32 = (1e-6, 1e-5)
LOSS = (0.0, 1e-5)
SCALE = (0.0, 1e-6)
STATS = (1e-7, 1e-6)
EXACT = (0.0, 0.0)

SD_BATCH = 4
# The 8-bit moments round to codes: a gradient averaged over ranks that hold
# other rows differs from the one-card gradient in its last bits and moves a
# code at a rounding edge by one. Its global batch of 3 rows does not split
# over the data axis, so every rank runs the whole batch (shard_batch's
# replicated path) and holds the one-card gradient bit for bit: the codes and
# scales then show the whole-leaf blocks, which a shard's own would not give.
REPLICATED_ROWS = 3
SD_STEPS = 2


def err(got, want, tol) -> float:
    """The worst |got - want| as a share of atol + rtol·|want| (0 when equal)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    diff = np.abs(got - want)
    if not diff.size or not diff.max():
        return 0.0
    bound = tol[0] + tol[1] * np.abs(want)
    share = np.where(bound > 0, diff / np.where(bound > 0, bound, 1), np.inf)
    return float(np.max(np.where(diff > 0, share, 0.0)))


# -- engines ----------------------------------------------------------------------


def sd_config(optimizer: dict, ema: bool, plain: bool = False) -> dict:
    """sd15-tiny's model node in fp32 with ``optimizer``; unless ``plain``,
    with log_sigmas, a noise offset drawn by chance, UCG on the text and
    dropout, so that every per-row draw and the gathered metrics take part."""
    from neurosis_tpu_torch.config.loader import load_config

    cfg = load_config(ROOT / "configs/smoke/sd15-tiny.yaml")["model"]
    ia = cfg["init_args"]
    ia["use_ema"] = ema
    ia["optimizer"] = optimizer
    if not plain:
        ia["log_sigmas"] = True
        ia["loss_fn"]["init_args"].update(noise_offset=0.1, noise_offset_chance=0.5)
        ia["conditioner"]["init_args"]["emb_models"][0]["init_args"]["ucg_rate"] = 0.3
        ia["model"]["init_args"]["dropout"] = 0.1
    # 64 channels: at sd15-tiny's 32 every GroupNorm group is one channel, so
    # the bias of a conv before one has a gradient of exactly zero, and a
    # normalising optimizer turns its rounding noise into a full step
    ia["model"]["init_args"]["model_channels"] = 64
    return cfg


# The AdamWs at their rates in the repository's configs (vae-tiny's optax.adamw,
# sdxl-te's AdamW8bit): an Adam step normalises each element, and at 1e-3 the
# fp32 reduction-order noise of the zero-initialised layers' near-cancelling
# gradients moves a parameter by more than 1e-6.
OPTIMIZERS = {
    "adafactor": {"class_path": "neurosis.optimizers.Adafactor",
                  "init_args": {"scale_parameter": True, "relative_step": True, "warmup_init": False}},
    "came": {"class_path": "neurosis.optimizers.CAME", "init_args": {"lr": 1e-3, "weight_decay": 0.01}},
    "adamw": {"class_path": "optax.adamw", "init_args": {"learning_rate": 1e-4}},
    "adamw8bit": {"class_path": "bitsandbytes.optim.AdamW8bit", "init_args": {"lr": 3e-5}},
}


def sd_engine(optimizer: str, ema: bool = False):
    from neurosis_tpu_torch.trainer.builder import build_engine

    return build_engine(sd_config(OPTIMIZERS[optimizer], ema), device="cpu",
                        generator=torch.Generator().manual_seed(0))


def sd_batch(seed: int, rows: int = SD_BATCH) -> dict:
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, size=(rows, 16, 16, 3)).astype(np.uint8),
            "caption_ids": rng.randint(0, 49406, size=(rows, 77)).astype(np.int64),
            "uncond_ids": np.full((1, 77), 49407, np.int64)}


# -- runs ----------------------------------------------------------------------------


class Run:
    """A trainer without data: the port's loop pieces that a CLI run uses
    (wrapping, batch sharding, the step under its rows, the metrics'
    average, checkpoints) on batches given here."""

    def __init__(self, engine, mesh=None, seed: int = 0):
        from neurosis_tpu_torch.trainer.loop import Trainer

        self.trainer = Trainer(engine, default_root_dir=str(OUT / "unused"), tokenizer=object(), seed=seed,
                               mesh=mesh)
        self.state = self.trainer._start("fit")

    def step(self, batch: dict, fn=None):
        arrays, rows = dict(batch), None
        if self.trainer.mesh is not None:
            arrays, rows = self.trainer.mesh.shard(arrays)
        fn = fn or self.trainer.engine.train_step
        self.state, metrics = self.trainer._step(fn, self.state, self.trainer._to_device(arrays), rows)
        metrics.pop("step_ms")
        return metrics

    def params(self) -> dict:
        from neurosis_tpu_torch.trainer.callbacks import state_payload

        return {k: v.cpu().numpy() for k, v in state_payload(self.trainer.engine, self.state)["params"].items()}

    def payload(self) -> dict:
        from neurosis_tpu_torch.trainer.callbacks import state_payload

        return state_payload(self.trainer.engine, self.state)

    def load(self, payload: dict) -> None:
        from neurosis_tpu_torch.trainer.callbacks import load_state_payload

        load_state_payload(self.trainer.engine, self.state, payload)


def _cpu(tree):
    """A payload with each tensor copied to the host (numpy reads them)."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def sd_run(optimizer: str, mesh=None, ema: bool = False, payload=None, rows: int = SD_BATCH) -> dict:
    """SD_STEPS steps on global batches of ``rows`` (one more after loading
    ``payload`` when given) → their metrics and the payload after them."""
    run = Run(sd_engine(optimizer, ema), mesh)
    out = {"metrics": []}
    if payload is not None:
        run.load(payload)
        out["metrics"].append(run.step(sd_batch(100, rows)))
    else:
        for i in range(SD_STEPS):
            out["metrics"].append(run.step(sd_batch(i, rows)))
    out["payload"] = _cpu(run.payload())
    return out


def compare_sd(got: dict, want: dict, param_tol=F32) -> dict:
    res = {}
    for key in want["metrics"][0]:
        res[f"metric/{key}"] = max(err(g[key], w[key], LOSS) for g, w in zip(got["metrics"], want["metrics"]))
    gp, wp = got["payload"], want["payload"]
    res["params"] = max(err(gp["params"][k], v, param_tol) for k, v in wp["params"].items())
    if "ema_params" in wp:
        res["ema"] = max(err(gp["ema_params"][k], v, F32) for k, v in wp["ema_params"].items())
    return res


def compare_8bit(got: dict, want: dict) -> dict:
    res = compare_sd(got, want)
    gs, ws = got["payload"]["opt_state"]["state"], want["payload"]["opt_state"]["state"]
    codes = scales = 0.0
    for i, st in ws.items():
        for k, v in st.items():
            if k.endswith("codes"):
                codes = max(codes, err(gs[i][k], v, EXACT))
            else:
                scales = max(scales, err(gs[i][k], v, SCALE))
    res["codes"], res["scales"] = codes, scales
    return res


# -- the VAE-GAN pair ------------------------------------------------------------------------

DD = dict(ch=64, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], resolution=32, z_channels=4)
VQ_LOSS = dict(disc_start=1, disc_num_layers=1, perceptual_weight=0.1, disc_weight=0.6, codebook_weight=0.8,
               lpips_type="alex")


def vae_engine(actnorm: bool = False):
    """vae-tiny's Encoder and Decoder at 64 channels over an EMA codebook, the
    VQ GAN loss with its BatchNorm PatchGAN (an ActNorm one with
    ``actnorm``), the adaptive GAN weight and EMA shadows, trained by SGD:
    at 32 channels a GroupNorm group is one channel, and the attention key
    bias's gradient is exactly zero (softmax ignores a shift), so an Adam
    step would turn rounding noise into a full step."""
    from neurosis_tpu_torch.losses.discriminator_loss import VQLPIPSWithDiscriminator
    from neurosis_tpu_torch.losses.patchgan import NLayerDiscriminator
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.modules.regularizers import EMAVectorQuantizer
    from neurosis_tpu_torch.optimizers.adamw import sgd
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    g = torch.Generator().manual_seed(0)
    reg = EMAVectorQuantizer(16, 4, decay=0.9, device="cpu")
    with torch.no_grad():
        reg.embedding.weight.normal_(generator=g)
    loss = VQLPIPSWithDiscriminator(**VQ_LOSS, device="cpu", generator=g)
    if actnorm:
        loss.discriminator = NLayerDiscriminator(3, n_layers=VQ_LOSS["disc_num_layers"], use_actnorm=True,
                                                 device="cpu", generator=g)
    return AutoencodingEngine(Encoder(**DD, double_z=False, device="cpu", generator=g),
                              Decoder(out_ch=3, **DD, device="cpu", generator=g), loss,
                              lambda ps: sgd(ps, 1e-4), lambda ps: sgd(ps, 1e-4), regularizer=reg,
                              sample_posterior=False, use_ema=True, ema_decay=0.9, disc_start=1,
                              adaptive_disc_weight=True, device="cpu")


def vae_batch(seed: int) -> dict:
    return {"image": np.random.RandomState(seed).randint(0, 256, size=(SD_BATCH, 32, 32, 3)).astype(np.uint8)}


def vae_run(mesh=None) -> dict:
    """A G step (the GAN term still gated), a D step, then a G step with the
    GAN term on. The parameters and EMA shadows are taken after the first
    two; at the third the adaptive weight sits at its clamp (1e4·0.6), so
    that step scales the GAN gradient's fp32 rounding by 6000 and only its
    metrics, the codebook and the statistics are held. The codebook indices
    are those of both G steps' batches, gathered."""
    from neurosis_tpu_torch.parallel import rows

    run = Run(vae_engine(), mesh)
    engine = run.trainer.engine
    indices = []
    engine.regularizer.register_forward_hook(lambda m, i, out: indices.append(rows.gather(out[1]["indices"])))
    out = {"metrics": [run.step(vae_batch(0), engine.g_step), run.step(vae_batch(1), engine.d_step)]}
    out["payload"] = _cpu(run.payload())
    out["metrics"].append(run.step(vae_batch(2), engine.g_step))
    out["reg_stats"] = _cpu(run.payload())["reg_stats"]
    out["batchnorm"] = {n: b.clone() for n, b in engine.discriminator.named_buffers()}
    out["indices"] = torch.cat([i.reshape(-1) for i in indices]).numpy()
    return out


def compare_vae(got: dict, want: dict) -> dict:
    res = {}
    for key in sorted(set(want["metrics"][0]) | set(want["metrics"][1])):
        res[f"metric/{key}"] = max(err(g[key], w[key], LOSS) for g, w in zip(got["metrics"], want["metrics"])
                                   if key in w)
    gp, wp = got["payload"], want["payload"]
    res["params"] = max(err(gp["params"][k], v, F32) for k, v in wp["params"].items())
    res["ema"] = max(err(gp["ema_params"][k], v, F32) for k, v in wp["ema_params"].items())
    res["codebook"] = max(err(got["reg_stats"][k], v, LOSS) for k, v in want["reg_stats"].items())
    res["batchnorm"] = max(err(got["batchnorm"][k], v, STATS) for k, v in want["batchnorm"].items())
    res["indices"] = err(got["indices"], want["indices"], EXACT)
    return res


def actnorm_run(mesh=None) -> dict:
    """A G step and a D step over an ActNorm PatchGAN: its loc and scale come
    from the first batch it sees (inside the wrapped G step's forward), then
    train."""
    run = Run(vae_engine(actnorm=True), mesh)
    engine = run.trainer.engine
    metrics = [run.step(vae_batch(0), engine.g_step), run.step(vae_batch(1), engine.d_step)]
    return {"metrics": metrics, "payload": _cpu(run.payload())}


def compare_actnorm(got: dict, want: dict) -> dict:
    res = {f"metric/{k}": max(err(g[k], w[k], LOSS) for g, w in zip(got["metrics"], want["metrics"]) if k in w)
           for k in set(want["metrics"][0]) | set(want["metrics"][1])}
    params = got["payload"]["params"]
    res["params"] = max(err(params[k], v, F32) for k, v in want["payload"]["params"].items())
    res["actnorm"] = max(err(params[k], v, F32) for k, v in want["payload"]["params"].items()
                         if k.endswith((".loc", ".scale")))
    return res


# -- checkpoints across world sizes ----------------------------------------------------------


def resumed(payload, mesh=None) -> dict:
    """A third Adafactor step (with EMA) from ``payload``."""
    return sd_run("adafactor", mesh, ema=True, payload=payload)


# -- one step held against JAX's mesh step ---------------------------------------------------


def jax_step(mesh, inputs: Path) -> dict:
    """One Adafactor step of the engine, weights, batch and draws that
    ``tests/test_torch_distributed.py`` gives JAX's ``train_step`` on its
    (1, 2) mesh: the loss, the grad norm and the parameters after it."""
    from neurosis_tpu_torch.trainer.builder import build_engine

    for _ in range(600):  # written by the test while the ranks run
        if inputs.exists():
            break
        time.sleep(0.5)
    data = np.load(inputs)
    cfg = sd_config(OPTIMIZERS["adafactor"], ema=False, plain=True)
    engine = build_engine(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for prefix, module in (("model.", engine.model), ("conditioner.", engine.conditioner)):
        module.load_state_dict({k[len(prefix):]: torch.tensor(data[k]) for k in data.files if k.startswith(prefix)},
                               strict=True)
    run = Run(engine, mesh)
    batch = {k: data[k] for k in ("latents", "caption_ids", "uncond_ids")}
    t, noise = torch.tensor(data["t"]), torch.tensor(data["noise"])
    metrics = run.step(batch, lambda state, b: engine.train_step(state, b, t=t, noise=noise))
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
            "params": {k: v.numpy() for k, v in _cpu(run.payload())["params"].items()}}


# -- ring attention over the ranks -----------------------------------------------------------

RING_SHAPE = (2, 3, 64, 16)  # B, H, S, D: S splits over 2 and 4 ranks
RING_ODD_S = 66  # divisible by 2, not by 4: ring at n = 2, the whole sequence at n = 4
FWD = (3e-6, 1e-4)  # tests/test_flash_attention.py:51,58
GRAD = (2e-5, 1e-3)


def ring_inputs(s: int = RING_SHAPE[2]) -> list:
    """q, k, v and dO [B, H, S, D] fp32, the same on every rank."""
    rng = np.random.RandomState(7 + s)
    b, h, _, d = RING_SHAPE
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(4)]


def _attend(fn, arrays):
    """fn(q, k, v) and its q/k/v gradients for dO, as numpy."""
    q, k, v, do = (torch.tensor(a, requires_grad=i < 3) for i, a in enumerate(arrays))
    o = fn(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    return [o.detach().numpy()] + [g.numpy() for g in grads]


def ring_check(out: Path) -> dict:
    """The ring over every rank of the world against the port's plain
    attention on the whole sequence: O and q/k/v grads (each rank's gathered
    ones equal rank 0's); at S not divisible by the ring, the dispatch's
    whole-sequence path. Rank 0 writes its results for the test's JAX
    comparison and returns the errors as shares of FWD and GRAD."""
    import torch.distributed as dist

    from neurosis_tpu_torch.ops.attention import dot_product_attention, plain_attention
    from neurosis_tpu_torch.ops.ring_attention import P2PRing, on_axis

    ring = P2PRing(dist.group.WORLD)
    res, saved = {}, {}
    for label, s in (("ring", RING_SHAPE[2]), ("odd", RING_ODD_S)):
        arrays = ring_inputs(s)
        with on_axis("context", ring):
            got = _attend(lambda q, k, v: dot_product_attention(q, k, v, context_axis="context"), arrays)
        want = _attend(plain_attention, arrays)
        tols = (FWD, GRAD, GRAD, GRAD)
        exact = label == "odd" and s % ring.n
        for name, g, w, tol in zip(("o", "dq", "dk", "dv"), got, want, tols):
            res[f"{label}/{name}"] = err(g, w, EXACT if exact else tol)
            saved[f"{label}/{name}"] = g
        mine = torch.tensor(np.stack(got))
        every = [torch.empty_like(mine) for _ in range(ring.n)]
        dist.all_gather(every, mine)
        res[f"{label}/ranks_agree"] = max(err(e.numpy(), every[0].numpy(), EXACT) for e in every)
    if dist.get_rank() == 0:
        np.savez(out, **saved)
    return res


# -- the CLI's fit on the mesh ----------------------------------------------------------------


@contextlib.contextmanager
def one_process():
    """The launcher's variables hidden, so that the CLI runs the one-card path."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.pop(k) for k in keys if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def cli_fit(root: Path, strategy: str = "ddp", **kwargs) -> None:
    """``fit`` of ``cli_config(root, strategy, ...)`` through the CLI's main,
    as under torchrun (or in one process, under ``one_process``)."""
    from neurosis_tpu_torch.trainer.cli import main as cli_main

    cli_main(["fit", "-c", str(cli_config(root, strategy=strategy, **kwargs)), "--device", "cpu"])


def cli_config(root: Path, strategy: str = "", devices: int = 0, fsdp: int = 0, context: int = 0,
               remat: bool = False) -> Path:
    """sd15-tiny in fp32 for 2 steps of 2 images, a checkpoint every step,
    in ``root``; with ``strategy``, ``devices``, ``fsdp`` and
    ``context`` (``context_parallel``) the mesh's; with ``remat`` the UNet's
    transformer blocks checkpointed (remat policy full)."""
    text = (ROOT / "configs/smoke/sd15-tiny.yaml").read_text()
    edits = [("  precision: bf16-mixed\n", ""), ("  fast_dev_run: true\n", "  max_steps: 2\n"),
             ("  max_steps: 1\n", ""), ("    resolution: 64\n    image_key: image\n",
                                      "    resolution: 32\n    batch_size: 2\n    num_workers: 0\n    image_key: image\n"),
             ("seed_everything: 42\n", "seed_everything: 42\nmodel_checkpoint:\n  every_n_train_steps: 1\n"),
             ("  default_root_dir: ${oc.env:NEUROSIS_SMOKE_ROOT,./projects/smoke}\n",
              f"  default_root_dir: {root}\n" + (f"  strategy: {strategy}\n" if strategy else "")
              + (f"  devices: {devices}\n" if devices else "") + (f"  fsdp: {fsdp}\n" if fsdp else "")
              + (f"  context_parallel: {context}\n" if context else ""))]
    if remat:
        edits.append(("        context_dim: 64\n", "        context_dim: 64\n        use_checkpoint: true\n"))
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = root.parent / f"{root.name}.yaml"
    # every rank writes the same file: each through its own temporary, renamed over it, so that no
    # rank reads the file while another has truncated it
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)
    return path


# -- main ---------------------------------------------------------------------------------

MESHES = {"data2": (2, 1), "fsdp2": (1, 2), "data2xfsdp2": (2, 2)}


def main():
    """Every scenario of one mesh; its checkpoint scenarios on the two-rank
    meshes, JAX's step on fsdp 2 and the CLI's fit on data 2."""
    global OUT
    rank, store, OUT, name = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]), sys.argv[4]
    data, fsdp = MESHES[name]
    world = data * fsdp
    torch.set_num_threads(1)
    import torch.distributed as dist

    from neurosis_tpu_torch.parallel.mesh import DistEnv, init_distributed, make_mesh

    dist_ = init_distributed("cpu", DistEnv(rank, world, rank, world), init_method=f"file://{store}")
    t0 = time.perf_counter()
    times, ref, res = {}, {}, {}
    one_rank_ckpt = OUT / f"one_rank_{name}.pt"
    if rank == 0:
        with one_process():  # the one-process fits the test holds the mesh fits against
            if name == "data2":
                cli_fit(OUT / "cli_one", strategy="")
            if name == "fsdp2":
                cli_fit(OUT / "cli_one_remat", strategy="", remat=True)
        for opt in OPTIMIZERS:
            ref[opt] = sd_run(opt, ema=opt == "adafactor", rows=REPLICATED_ROWS if opt == "adamw8bit" else SD_BATCH)
        ref["vae"] = vae_run()
        if world == 2:
            ref["actnorm"] = actnorm_run()
            torch.save(ref["adafactor"]["payload"], one_rank_ckpt)
            ref["resumed"] = resumed(ref["adafactor"]["payload"])
    times["reference"] = time.perf_counter() - t0
    dist.barrier()
    if name in ("data2", "data2xfsdp2"):  # the ring over 2 and over 4 ranks
        ring = ring_check(OUT / f"ring_{name}.npz")
        if rank == 0:
            res["ring"] = ring
    mesh = make_mesh(dist_, data, fsdp)
    for opt in OPTIMIZERS:
        got = sd_run(opt, mesh, ema=opt == "adafactor", rows=REPLICATED_ROWS if opt == "adamw8bit" else SD_BATCH)
        if rank == 0:
            res[opt] = (compare_8bit if opt == "adamw8bit" else compare_sd)(got, ref[opt])
            if opt == "adafactor" and world == 2:  # its N-rank checkpoint, resumed by one process
                res["ckpt_n_to_1"] = compare_sd(resumed(got["payload"]), ref["resumed"])
    got = vae_run(mesh)
    if rank == 0:
        res["vae_pair"] = compare_vae(got, ref["vae"])
    if world == 2:
        got = actnorm_run(mesh)
        if rank == 0:
            res["actnorm_pair"] = compare_actnorm(got, ref["actnorm"])
        got = resumed(torch.load(one_rank_ckpt, weights_only=True), mesh)
        if rank == 0:
            res["ckpt_1_to_n"] = compare_sd(got, ref["resumed"])
    if name == "fsdp2":
        got = jax_step(mesh, OUT / "jax_inputs.npz")
        if rank == 0:
            np.savez(OUT / "jax_step_port.npz", loss=got["loss"], grad_norm=got["grad_norm"],
                     **{"params/" + k: v for k, v in got["params"].items()})
    if name == "data2":
        cli_fit(OUT / "cli_mesh")
    if name in ("fsdp2", "data2xfsdp2"):  # the UNet's self-attention on the ring, through the CLI
        from neurosis_tpu_torch.ops.ring_attention import ring_self_attention

        calls = ring_self_attention.calls
        if name == "fsdp2":
            cli_fit(OUT / "cli_context2", strategy="", devices=2, context=2, remat=True)
        else:
            cli_fit(OUT / "cli_fsdp2_context2", strategy="fsdp", devices=4, fsdp=2, context=2, remat=True)
        res["context_fit_ring_calls"] = ring_self_attention.calls - calls
    times[name] = time.perf_counter() - t0
    if rank == 0:
        (OUT / f"{name}.json").write_text(json.dumps({"results": res, "seconds": times}, indent=1))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
