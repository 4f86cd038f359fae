"""The JAX arm of the port's loss-curve check, made on the CPU.

The port's ``UNetModel(**cfg)`` is built on the CPU with its numpy init
(``neurosis_tpu_torch.tools.loss_curve.numpy_init_``); its state dict,
copied, goes into JAX's UNet through ``import_torch_params``; JAX then trains
on the port's data and σ/noise streams with the loss of
``tools/loss_curve_stat.py``'s JAX arm and ``optax.adam``. This is the only
place that imports both packages for the check.

Make the committed curve (about 30-40 minutes on 8 cores):
  python tests/torch_loss_curve_jax.py --seed 0 --steps 200 --res 32 \\
      --out neurosis_tpu_torch/assets/loss_curve/jax_bf16_r32_seed0.json
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from neurosis_tpu_torch.tools import loss_curve as lc  # noqa: E402


def init_state_dict(cfg: dict, init_seed: int = 0) -> tuple[dict, float]:
    """The port's numpy init as {torch key: numpy copy} and its checksum."""
    model, checksum = lc.build_unet(None, "cpu", cfg, init_seed)
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}, checksum


def run_jax(steps: int, seed: int, res: int, dtype: str = "bf16", cfg: dict = None, lr: float = lc.LR,
            init_seed: int = 0, log_every: int = 0) -> dict:
    """JAX's curve from the port's numpy init: losses, grad norms, checksum."""
    import jax
    import jax.numpy as jnp
    import optax

    from neurosis_tpu.checkpoint import import_torch_params
    from neurosis_tpu.diffusion import EpsPreconditioning, EpsWeighting
    from neurosis_tpu.models.unet import UNetModel
    from neurosis_tpu.utils import append_dims

    cfg = cfg or lc.CFG
    sd, checksum = init_state_dict(cfg, init_seed)
    jdtype = {"bf16": jnp.bfloat16, "fp32": None}[dtype]
    model = UNetModel(**cfg, dtype=jdtype, remat_policy="none")
    ctx_dim = cfg["context_dim"]
    tmpl = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((lc.BATCH, res, res, 4)),
                                             jnp.zeros((lc.BATCH,)), jnp.zeros((lc.BATCH, lc.CONTEXT_LEN, ctx_dim))))
    params, missing, unexpected = import_torch_params(tmpl["params"], sd)
    assert not missing and not unexpected, (missing, unexpected)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), params)

    pc, w_fn = EpsPreconditioning(), EpsWeighting()
    opt = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    opt_state = opt.init(params)

    def loss_fn(p, x0, ctx, sig, noise):
        s = append_dims(sig, 4)
        z_t = x0 + s * noise
        c_skip, c_out, c_in, c_noise = pc(s)
        out = model.apply({"params": p}, (z_t * c_in).astype(jdtype or z_t.dtype), c_noise.reshape(-1), ctx)
        denoised = out.astype(jnp.float32) * c_out + z_t * c_skip
        return (jnp.mean((denoised - x0) ** 2, axis=(1, 2, 3)) * w_fn(sig)).mean()

    @jax.jit
    def step(p, opt_state, x0, ctx, sig, noise):
        loss, grads = jax.value_and_grad(loss_fn)(p, x0, ctx, sig, noise)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, optax.global_norm(grads)

    losses, norms = [], []
    t0 = time.perf_counter()
    streams = zip(lc.data_stream(steps, res, ctx_dim), lc.sigma_noise_stream(steps, seed, lc.ddpm_sigmas(), res))
    for i, ((x0, ctx), (sig, noise)) in enumerate(streams):
        params, opt_state, loss, norm = step(params, opt_state, jnp.asarray(x0.transpose(0, 2, 3, 1).copy()),
                                             jnp.asarray(ctx.copy()), jnp.asarray(sig.copy()),
                                             jnp.asarray(noise.transpose(0, 2, 3, 1).copy()))
        losses.append(float(loss))
        norms.append(float(norm))
        if log_every and i % log_every == 0:
            print(f"jax[{dtype}] step {i}: {losses[-1]:.4f} ({time.perf_counter() - t0:.0f}s)", flush=True)
    return {"losses": losses, "grad_norms": norms, "init_checksum": checksum,
            "seconds": time.perf_counter() - t0, "jax_version": jax.__version__}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="JAX's arm of the port's loss-curve check, on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--res", type=int, default=lc.RES)
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    run = run_jax(args.steps, args.seed, args.res, args.dtype, log_every=20)
    payload = {"side": "jax", "dtype": args.dtype, "seed": args.seed, "steps": args.steps, "res": args.res,
               "cfg": lc.CFG, "batch": lc.BATCH, "lr": lc.LR, "data_seed": lc.DATA_SEED,
               "command": "python " + " ".join(shlex.quote(a) for a in ["tests/torch_loss_curve_jax.py",
                                                                          *(argv or sys.argv[1:])]),
               "cpu_count": os.cpu_count(), **run}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out} ({run['seconds']:.0f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
