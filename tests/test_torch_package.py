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
        "import chip_smoke\n"
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
    # the smoke script may time SDPA as a yardstick, but imports nothing of JAX
    assert not _FORBIDDEN_IMPORT.search((ROOT / "chip_smoke.py").read_text())


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


@pytest.mark.parametrize("name", ["DiscreteDenoiser", "DiscreteSigmaGenerator", "Encoder", "Decoder",
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
    """Off the CPU a shape or dtype the kernel does not take raises rather
    than falling back: bf16 head dims other than 40/64/80/160/512, fp32 at
    any head dim but 512 (forward and backward), mixed dtypes, the overlap
    kernels at any head dim but 64 or in fp32, a filter of the wrong size."""
    from neurosis_tpu_torch.ops.conv3x3 import conv3x3_nhwc
    from neurosis_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from neurosis_tpu_torch.ops.flash_overlap import flash_fwd_chunked, flash_fwd_split2

    odd_d = torch.empty(1, 1, 16, 96, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd(odd_d, odd_d, odd_d)
    f32 = torch.empty(1, 1, 16, 40, device="meta")
    with pytest.raises(ValueError, match="fp32 kernel takes head dims"):
        flash_fwd(f32, f32, f32)
    bf16 = torch.empty(1, 1, 16, 512, device="meta", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        flash_fwd(bf16, bf16.float(), bf16)
    stat = torch.empty(1, 1, 16, device="meta")
    with pytest.raises(ValueError, match="fp32 kernel takes head dims"):  # the fp32 backward is d=512 only
        flash_bwd(f32, f32, f32, f32, stat, stat, 0.1)
    with pytest.raises(TypeError, match="fp32"):  # an fp32 forward's bf16 cotangent
        flash_bwd(bf16.float(), bf16.float(), bf16.float(), bf16, stat, stat, 0.1)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd_split2(odd_d, odd_d, odd_d)
    with pytest.raises(TypeError, match="bf16"):
        flash_fwd_chunked(*(torch.empty(1, 1, 16, 64, device="meta"),) * 3, 2)
    img = torch.empty(1, 32, 32, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bad shapes"):
        conv3x3_nhwc(img, torch.empty(3, 3, 64, 128, device="meta", dtype=torch.bfloat16))

