"""Rules of the neurosis_tpu_torch package: it imports neither JAX nor the
JAX package (nor the safetensors package, absent on the card's machine),
calls no library attention kernel and no torch.compile, builds on CUDA
unless told otherwise, and hands non-CPU tensors to its kernels rather than
to their plain versions."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "neurosis_tpu_torch"
_FORBIDDEN_IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|flax|optax|neurosis_tpu|safetensors)\b", re.M)


def test_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import neurosis_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'neurosis_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "import chip_smoke, conv_tiles, conv_times, flash_times\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'neurosis_tpu',"
        " 'safetensors')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 45  # every module of the package was imported


def test_sources_call_no_library_kernel():
    sources = sorted(PKG.rglob("*.py"))
    assert sources
    for path in sources:
        text = path.read_text()
        assert not _FORBIDDEN_IMPORT.search(text), path
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path
    # the smoke and timing scripts may time SDPA or F.conv2d as a yardstick, but import nothing of JAX
    for script in ("chip_smoke.py", "conv_tiles.py", "conv_times.py", "flash_times.py"):
        assert not _FORBIDDEN_IMPORT.search((ROOT / script).read_text()), script


def test_entry_points_default_to_cuda(monkeypatch):
    from neurosis_tpu_torch import resolve_device
    from neurosis_tpu_torch.models.text_encoder.clip import CLIPTextTower
    from neurosis_tpu_torch.models.unet import UNetModel

    tiny = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1, attention_resolutions=[2],
                channel_mult=[1, 2], num_heads=2, context_dim=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: UNetModel(**tiny, **kw), lambda **kw: CLIPTextTower(width=64, layers=1, heads=2, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        assert next(build(device="cpu").parameters()).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _entry_points():
    """Every public constructor of the port that makes tensors, at tiny widths."""
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu_torch.losses.lpips import LPIPS
    from neurosis_tpu_torch.losses.patchgan import NLayerDiscriminator
    from neurosis_tpu_torch.losses.vae_loss import AutoencoderLPIPSWithDiscr, AutoencoderPerceptual
    from neurosis_tpu_torch.models.autoencoder import AutoencoderKL
    from neurosis_tpu_torch.models.vae import Decoder, Encoder

    from neurosis_tpu_torch.models.text_encoder.clip import OpenCLIPTextTower
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenCLIPEmbedder, FrozenOpenCLIPEmbedder2
    from neurosis_tpu_torch.tools import overlap_bench

    dd = dict(ch=32, ch_mult=[1], num_res_blocks=1, z_channels=2)
    tower = dict(width=32, layers=1, heads=2)
    return {
        "OpenCLIPTextTower": (lambda **kw: OpenCLIPTextTower(**tower, **kw), lambda m: m.text_projection),
        "FrozenCLIPEmbedder": (lambda **kw: FrozenCLIPEmbedder(layer="hidden", layer_idx=0, **tower, **kw),
                               lambda m: next(m.parameters())),
        "FrozenOpenCLIPEmbedder2": (lambda **kw: FrozenOpenCLIPEmbedder2(**tower, **kw),
                                    lambda m: m.model.positional_embedding),
        "overlap_bench.make_inputs": (lambda **kw: overlap_bench.make_inputs(64, 64, 1, 1, **kw), lambda qkv: qkv[2]),
        "DiscreteDenoiser": (lambda **kw: DiscreteDenoiser(EpsPreconditioning(), 10, LegacyDDPMDiscretization(), **kw),
                             lambda m: m.sigmas),
        "DiscreteSigmaGenerator": (lambda **kw: DiscreteSigmaGenerator(LegacyDDPMDiscretization(), 10, **kw),
                                   lambda m: m.sigmas),
        "LegacyDDPMDiscretization": (lambda **kw: LegacyDDPMDiscretization()(10, **kw), lambda sigmas: sigmas),
        "Encoder": (lambda **kw: Encoder(**dd, **kw), lambda m: next(m.parameters())),
        "Decoder": (lambda **kw: Decoder(out_ch=3, **dd, **kw), lambda m: next(m.parameters())),
        "AutoencoderKL": (lambda **kw: AutoencoderKL(dd, embed_dim=2, **kw), lambda m: m.quant_conv.weight),
        "LPIPS": (lambda **kw: LPIPS("alex", **kw), lambda m: m.lin0.model[1].weight),
        "NLayerDiscriminator": (lambda **kw: NLayerDiscriminator(n_layers=1, **kw),
                                lambda m: m.layers[3].running_var),
        "AutoencoderLPIPSWithDiscr": (lambda **kw: AutoencoderLPIPSWithDiscr(disc_n_layers=1, **kw),
                                      lambda m: m.perceptual_loss.shift),
        "AutoencoderPerceptual": (lambda **kw: AutoencoderPerceptual(**kw), lambda m: m.perceptual_loss.scale),
    }


@pytest.mark.parametrize("name", ["DiscreteDenoiser", "DiscreteSigmaGenerator", "LegacyDDPMDiscretization", "Encoder", "Decoder",
                                  "AutoencoderKL", "LPIPS", "NLayerDiscriminator", "AutoencoderLPIPSWithDiscr",
                                  "AutoencoderPerceptual", "OpenCLIPTextTower", "FrozenCLIPEmbedder",
                                  "FrozenOpenCLIPEmbedder2", "overlap_bench.make_inputs"])
def test_every_entry_point_resolves_its_device(monkeypatch, name):
    """Each constructor goes through resolve_device: CUDA unless asked, so
    without CUDA it raises instead of building on the CPU; device='cpu'
    builds there (the σ tables of the denoiser and the σ generator once
    landed on the CPU by default)."""
    build, probe = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    assert probe(build(device="cpu")).device.type == "cpu"


class _KernelReached(Exception):
    pass


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd", "flash_fwd_f32", "flash_bwd_f32", "flash_fwd_split2",
                                  "flash_fwd_chunked", "conv3x3", "gn_silu_conv3x3"])
def test_non_cpu_tensors_go_to_the_kernel(monkeypatch, name):
    """A wrapper runs its plain version only for CPU tensors: given tensors
    on another device (meta here) it heads for the kernel's library."""
    from neurosis_tpu_torch import _nvcc, ops

    def load(lib):
        raise _KernelReached(lib)

    monkeypatch.setattr(_nvcc, "load", load)
    meta = dict(device="meta", dtype=torch.bfloat16)
    x = torch.empty(1, 2, 64, 40, **meta)
    x32 = torch.empty(1, 1, 64, 512, device="meta")
    stat = torch.empty(1, 2, 64, device="meta")
    stat32 = torch.empty(1, 1, 64, device="meta")
    x64 = torch.empty(1, 2, 64, 64, **meta)
    img = torch.empty(1, 32, 32, 128, **meta)
    w = torch.empty(3, 3, 128, 128, **meta)
    ab = torch.empty(1, 128, device="meta")
    args = {
        "flash_fwd": (x, x, x),
        "flash_bwd": (x, x, x, x, stat, stat, 0.1),
        "flash_fwd_f32": (x32, x32, x32),
        "flash_bwd_f32": (x32, x32, x32, x32, stat32, stat32, 0.1),
        "flash_fwd_split2": (x64, x64, x64),
        "flash_fwd_chunked": (x64, x64, x64, 4),
        "conv3x3": (img, w),
        "gn_silu_conv3x3": (img, ab, ab, w),
    }[name]
    before = ops.launch_counts()[name]
    with pytest.raises(_KernelReached):
        ops.KERNEL_WRAPPERS[name](*args)
    assert ops.launch_counts()[name] == before


def test_kernel_refuses_what_it_cannot_take():
    """Off the CPU a dtype or shape no kernel takes raises rather than falling
    back: fp16 (forward and backward), mixed dtypes, head dims past 512 in
    bf16 and in fp32 (forward and backward), the overlap kernels at any head
    dim but 64 or in fp32, a filter of the wrong size."""
    from neurosis_tpu_torch.ops.conv3x3 import conv3x3_nhwc
    from neurosis_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from neurosis_tpu_torch.ops.flash_overlap import flash_fwd_chunked, flash_fwd_split2

    stat = torch.empty(1, 1, 16, device="meta")
    fp16 = torch.empty(1, 1, 16, 64, device="meta", dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16"):
        flash_fwd(fp16, fp16, fp16)
    with pytest.raises(TypeError, match="bf16"):
        flash_bwd(fp16, fp16, fp16, fp16, stat, stat, 0.1)
    for wide in (torch.empty(1, 1, 16, 576, device="meta", dtype=torch.bfloat16),
                 torch.empty(1, 1, 16, 1024, device="meta")):
        with pytest.raises(ValueError, match="head dims 1 to 512"):
            flash_fwd(wide, wide, wide)
        with pytest.raises(ValueError, match="head dims 1 to 512"):
            flash_bwd(wide, wide, wide, wide, stat, stat, 0.1)
    bf16 = torch.empty(1, 1, 16, 512, device="meta", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        flash_fwd(bf16, bf16.float(), bf16)
    with pytest.raises(TypeError, match="fp32"):  # an fp32 forward's bf16 cotangent
        flash_bwd(bf16.float(), bf16.float(), bf16.float(), bf16, stat, stat, 0.1)
    odd_d = torch.empty(1, 1, 16, 96, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd_split2(odd_d, odd_d, odd_d)
    with pytest.raises(TypeError, match="bf16"):
        flash_fwd_chunked(*(torch.empty(1, 1, 16, 64, device="meta"),) * 3, 2)
    img = torch.empty(1, 32, 32, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bad shapes"):
        conv3x3_nhwc(img, torch.empty(3, 3, 64, 128, device="meta", dtype=torch.bfloat16))


@pytest.fixture()
def kernel_stub(monkeypatch):
    """The kernels' libraries replaced by a stub whose entry points succeed
    and record (entry, head dim) for the flash kernels; the CUDA stream and
    SM count the wrappers ask for are stand-ins, so meta tensors go through
    every wrapper to its launch and on."""
    import types

    from neurosis_tpu_torch import _nvcc
    from neurosis_tpu_torch.ops import conv3x3, flash_attention

    calls = []

    class Lib:
        def __getattr__(self, entry):
            def launch(*args):
                if entry.startswith("flash_"):  # d follows the pointers and B, H, Sq, Skv
                    calls.append((entry, args[9] if "_fwd_" in entry else args[13]))
                return 0
            return launch

    monkeypatch.setattr(_nvcc, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (flash_attention, conv3x3):
        monkeypatch.setattr(mod, "sm_count", lambda index: 132)
    return calls


def _kernel_dims():
    from neurosis_tpu_torch.ops.flash_attention import F32_HEAD_DIMS, KERNEL_HEAD_DIMS

    return {"flash_fwd_bf16": KERNEL_HEAD_DIMS, "flash_bwd_bf16": KERNEL_HEAD_DIMS,
            "flash_fwd_f32": F32_HEAD_DIMS, "flash_bwd_f32": F32_HEAD_DIMS}


def test_head_dims_are_the_kernels():
    """The head dims the wrappers pad to are those the C entry points dispatch
    on: flash_fwd_bf16's switch (flash_bwd_bf16 has the same cases) and the
    fp32 entries' FLASH_F32_DISPATCH."""
    src = (PKG / "csrc" / "flash_attention.cu").read_text()
    bf16 = src[src.index("int flash_fwd_bf16("):src.index("int flash_bwd_bf16(")]
    bwd = src[src.index("int flash_bwd_bf16("):src.index("#define FLASH_F32_DISPATCH")]
    f32 = src[src.index("#define FLASH_F32_DISPATCH"):src.index("int flash_fwd_f32(")]
    cases = lambda text: tuple(int(c) for c in re.findall(r"case (\d+):", text))
    dims = _kernel_dims()
    assert cases(bf16) == cases(bwd) == dims["flash_fwd_bf16"]
    assert cases(f32) == dims["flash_fwd_f32"]


@pytest.mark.parametrize("dtype,d,dp", [
    (torch.bfloat16, 32, 40), (torch.bfloat16, 40, 40), (torch.bfloat16, 48, 64), (torch.bfloat16, 128, 160),
    (torch.bfloat16, 256, 512), (torch.float32, 40, 64), (torch.float32, 64, 64), (torch.float32, 80, 96),
    (torch.float32, 128, 160), (torch.float32, 512, 512)])
def test_padded_rows_reach_the_kernel(kernel_stub, dtype, d, dp):
    """A row of any head dim up to 512 in bf16 or fp32 goes through
    flash_attention, forward and backward, to the kernel at the padded head
    dim, counted as that kernel's launch; o and the grads keep the true one."""
    from neurosis_tpu_torch import ops
    from neurosis_tpu_torch.ops.flash_attention import flash_attention

    q = torch.empty(1, 2, 600, d, device="meta", dtype=dtype, requires_grad=True)
    k, v = (torch.empty(1, 2, 77, d, device="meta", dtype=dtype, requires_grad=True) for _ in range(2))
    before = ops.launch_counts()
    out = flash_attention(q, k, v)
    out.sum().backward()
    assert out.shape == q.shape and all(t.grad.shape == t.shape for t in (q, k, v))
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    assert kernel_stub == [(f"flash_fwd_{kind}", dp), (f"flash_bwd_{kind}", dp)]
    names = ("flash_fwd", "flash_bwd") if kind == "bf16" else ("flash_fwd_f32", "flash_bwd_f32")
    assert {n: c - before[n] for n, c in ops.launch_counts().items() if c != before[n]} == dict.fromkeys(names, 1)


# the model configs of the repository; the JAX package's apply_precision maps
# these precisions to bf16 (the UNet, or the VAE trainer's encoder and decoder),
# every other setting computes in fp32; the frozen first stage stays fp32
CONFIGS = sorted(str(p.relative_to(ROOT)) for sub in ("sd15", "sdxl", "vae", "smoke")
                 for p in (ROOT / "configs" / sub).glob("*.yaml"))
_BF16_PRECISIONS = {"bf16", "bf16-mixed", "bf16-true", "16", "16-mixed", "16-true", 16}


@pytest.mark.parametrize("config", CONFIGS)
def test_every_flash_row_of_the_configs_reaches_a_kernel(kernel_stub, monkeypatch, config):
    """The attention rows of each config, as the port's models make them at
    the config's dtype, resolution and batch (SDXL's configs name aspect
    buckets, not a resolution: the square bucket, 1024 px), on meta tensors:
    every row the gate sends to flash reaches a kernel launch at a head dim
    that kernel is built for, forward and backward, and none meets a refusal."""
    import inspect

    import yaml

    from neurosis_tpu_torch.models import autoencoder, unet, vae
    from neurosis_tpu_torch.modules import attention as attn_module
    from neurosis_tpu_torch.ops import attention
    from neurosis_tpu_torch.ops.flash_attention import flash_attention

    for mod in (unet, vae, autoencoder):
        monkeypatch.setattr(mod, "init_parameters", lambda module, generator: None)
    rows = []

    def watch(q, k, v, mask=None):
        rows.append((tuple(q.shape), tuple(k.shape), q.dtype, attention.uses_flash(q, mask)))
        return attention.dot_product_attention(q, k, v, mask)

    monkeypatch.setattr(attn_module, "dot_product_attention", watch)
    monkeypatch.setattr(vae, "dot_product_attention", watch)

    cfg = yaml.safe_load((ROOT / config).read_text())
    model, data = cfg["model"]["init_args"], cfg["data"]["init_args"]
    res, batch = data.get("resolution", 1024), data.get("batch_size", 1)
    dtype = torch.bfloat16 if cfg["trainer"].get("precision") in _BF16_PRECISIONS else None
    meta = dict(device="meta", generator=torch.Generator())
    image = torch.empty(batch, res, res, 3, device="meta")
    with torch.no_grad():
        if "ddconfig" in model:  # the VAE-GAN trainer: encoder and decoder in the trainer's dtype
            dd = model["ddconfig"]
            ae = autoencoder.AutoencoderKL(dd, embed_dim=dd["z_channels"], dtype=dtype, **meta)
            side = res // 2 ** (len(dd["ch_mult"]) - 1)
            ae.decode(ae.encode(image)[..., :dd["z_channels"]])
            assert ae.decode(torch.empty(batch, side, side, dd["z_channels"], device="meta")).shape == image.shape
        else:  # a diffusion engine: the frozen fp32 encode, then its UNet
            fs = model["first_stage_model"]["init_args"]
            autoencoder.AutoencoderKL(fs["ddconfig"], embed_dim=fs["embed_dim"], **meta).encode(image)
            args = model["model"]["init_args"]
            keep = inspect.signature(unet.UNetModel).parameters
            net = unet.UNetModel(**{k: v for k, v in args.items() if k in keep}, dtype=dtype, **meta)
            x = torch.empty(batch, res // 8, res // 8, args["in_channels"], device="meta")
            y = torch.empty(batch, args["adm_in_channels"], device="meta") if args.get("num_classes") else None
            net(x, torch.empty(batch, device="meta"), torch.empty(batch, 77, args["context_dim"], device="meta"), y=y)

    flash_rows = [r for r in rows if r[3]]
    assert flash_rows, f"{config}: no attention row reaches the flash gate"
    dims = _kernel_dims()
    fwd_calls = [c for c in kernel_stub if "_fwd_" in c[0]]
    assert len(fwd_calls) == len(flash_rows) == len(kernel_stub)
    for (entry, d), (q_shape, _, q_dtype, _) in zip(fwd_calls, flash_rows):
        assert entry == ("flash_fwd_bf16" if q_dtype == torch.bfloat16 else "flash_fwd_f32")
        assert d in dims[entry] and d >= q_shape[-1], (config, q_shape, q_dtype)
    kernel_stub.clear()
    distinct = sorted(set((q, kv, str(dt)) for q, kv, dt, _ in flash_rows))
    for q_shape, kv_shape, dt in distinct:
        dt = getattr(torch, dt.split(".")[-1])
        q = torch.empty(q_shape, device="meta", dtype=dt, requires_grad=True)
        kv = torch.empty(kv_shape, device="meta", dtype=dt, requires_grad=True)
        flash_attention(q, kv, kv).sum().backward()
    bwd_calls = [c for c in kernel_stub if "_bwd_" in c[0]]
    assert len(bwd_calls) == len(distinct)
    assert all(d in dims[entry] for entry, d in bwd_calls)


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::conv3x3_wgmma<true, 128>((anonymous namespace)::ConvTma)", "port kernels"),
    ("void (anonymous namespace)::conv3x3_wgmma<false, 64>((anonymous namespace)::ConvTma)", "port kernels"),
    ("void (anonymous namespace)::flash_fwd_wgmma<64>((anonymous namespace)::FwdTma)", "port kernels"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64", "library conv"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "library conv"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "library matmul"),
])
def test_profile_books_kernels_by_name(name, kind):
    """chip_smoke's profiles book the port's conv and flash kernels as the
    port's, and cuDNN's convs and cuBLAS's matmuls as the library's."""
    import chip_smoke

    assert chip_smoke.kernel_kind(name) == kind
