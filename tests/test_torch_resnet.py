"""clip_glass_torch's CLIP ModifiedResNet tower (models/clip/resnet.py) and
the CLIP model around it against the JAX package's, at TINY_RN sizes
(weights from the JAX init with non-trivial folded BatchNorms and biases,
carried across with weights/from_jax.py).

Tolerances, relative to the output's scale: 1e-5 in fp32 (cuDNN-free CPU
convs on both sides, summation order differs), 2e-2 in bf16 (one to two
bf16 ulps where roundings fall apart, the kernels' bf16 tolerance), 1e-4
for the whole CLIP (12 matmuls deep in the text tower, as
tests/test_torch_clip.py).
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.core.dtypes import FP32 as JFP32
from clip_glass_tpu.core.dtypes import Policy as JPolicy
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.clip import resnet as jresnet
from clip_glass_tpu.tokenizers import tokenize

from clip_glass_torch.core import pytree
from clip_glass_torch.core.dtypes import BF16, FP32, precast_params
from clip_glass_torch.models.clip import api as tapi
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.clip import resnet as tresnet
from clip_glass_torch.weights import from_jax, load, synthesize

from torch_parity import N, T, assert_close_scaled

JCFG = jclip.CLIPConfig(embed_dim=64, image_resolution=32, vision_layers=(1, 1, 1, 1),
                        vision_width=16, transformer_width=64, transformer_heads=1,
                        transformer_layers=2, vision_kind="rn")
TCFG = tclip.CLIPConfig(**dataclasses.asdict(JCFG))
JBF16 = JPolicy(jnp.float32, jnp.bfloat16)


@pytest.fixture(scope="module")
def params():
    """A JAX RN CLIP with its folded BNs, biases and LayerNorms redrawn (the
    init leaves them at 1 / 0), and the port's copy."""
    jp = jclip.init(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(7)

    def f(path, leaf):
        names = [str(getattr(p, "key", "")) for p in path]
        noise = rng.normal(size=np.shape(leaf)).astype(np.float32)
        if names[-1] == "scale" or names[-1].startswith("ln_"):
            return leaf + 0.1 * noise
        if names[-1] in ("bias", "b"):
            return leaf + 0.1 * noise
        return leaf
    jp = jax.tree_util.tree_map_with_path(f, jp)
    return jp, from_jax.convert_clip(jax.tree.map(np.asarray, jp))


def _images(seed, n=3):
    return np.random.default_rng(seed).uniform(size=(n, 3, 32, 32)).astype(np.float32)


def test_rn_config_matches_jax():
    assert TCFG.rn_config() == tresnet.TINY_RN
    assert dataclasses.asdict(TCFG.rn_config()) == dataclasses.asdict(JCFG.rn_config())
    assert dataclasses.asdict(tclip.RN50) == dataclasses.asdict(jclip.RN50)
    assert dataclasses.asdict(tresnet.RN50) == dataclasses.asdict(jresnet.RN50)
    assert (tresnet.RN50.heads, tresnet.RN50.embed_dim) == (32, 2048)
    assert tclip.RN50.rn_config() == tresnet.RN50


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_apply_matches_jax(params, policy):
    """The tower alone: stem, anti-aliased bottlenecks, attention pool."""
    jp, tp = params
    jpol, tpol, rtol = (JFP32, FP32, 1e-5) if policy == "fp32" else (JBF16, BF16, 2e-2)
    img = _images(1)
    want = np.asarray(jax.jit(lambda p, x: jresnet.apply(p, x, jresnet.TINY_RN, jpol))(
        jclip.precast_params(jp, jpol)["visual"], jnp.asarray(img)), np.float32)
    staged = precast_params(tp, tpol, tclip.PRECAST_EXCLUDE)
    got = tresnet.apply(staged["visual"], T(img), tresnet.TINY_RN, tpol)
    assert got.dtype == tpol.compute_dtype and tuple(got.shape) == (3, 64)
    assert_close_scaled(N(got), want, rtol)


def test_rn_clip_encode_image_and_text_match_jax(params):
    jp, tp = params
    img = _images(2)
    want = np.asarray(jax.jit(lambda p, x: jclip.encode_image(p, x, JCFG, JFP32))(
        jp, jnp.asarray(img)))
    assert_close_scaled(N(tclip.encode_image(tp, T(img), TCFG, FP32)), want, 1e-4)
    ids = tokenize(["a red flower", "the face of a man with brown eyes"])
    want = np.asarray(jax.jit(lambda p, t: jclip.encode_text(p, t, JCFG, JFP32))(
        jp, jnp.asarray(ids)))
    assert_close_scaled(N(tclip.encode_text(tp, torch.as_tensor(ids), TCFG, FP32)), want, 1e-4)


def test_attnpool_joins_qkv(params):
    jp, tp = params
    ap, jap = tp["visual"]["attnpool"], jp["visual"]["attnpool"]
    np.testing.assert_array_equal(
        N(ap["in_proj_weight"]),
        np.concatenate([np.asarray(jap[k]["w"]) for k in "qkv"], axis=1))
    np.testing.assert_array_equal(N(ap["out_proj_weight"]), np.asarray(jap["c"]["w"]))
    assert tuple(tp["visual"]["stem"]["conv1"].shape) == (8, 3, 3, 3)  # OIHW


def test_bf16_staging_keeps_the_folded_bns_fp32(params):
    _, tp = params
    staged = precast_params(tp, BF16, tclip.PRECAST_EXCLUDE)
    block = staged["visual"]["layer2"][0]
    assert block["bn1"]["scale"].dtype == block["downsample"]["bn"]["bias"].dtype == torch.float32
    assert block["conv2"].dtype == block["downsample"]["conv"].dtype == torch.bfloat16
    assert staged["visual"]["attnpool"]["in_proj_weight"].dtype == torch.bfloat16


def test_port_init_matches_jax_structure(params):
    _, tp = params
    port = tclip.init(torch.Generator().manual_seed(0), TCFG)
    shapes = {k: tuple(v.shape) for k, v in pytree.flatten(port).items()}
    assert shapes == {k: tuple(v.shape) for k, v in pytree.flatten(tp).items()}
    assert len(port["visual"]["layer1"]) == 1 and "downsample" in port["visual"]["layer1"][0]


def test_rn_npz_with_sidecar_and_pt_load(tmp_path):
    """A converted RN `.npz` (stages as lists, per-stage counts in the
    sidecar) and the `.pt` it came from load to the same parameters; the
    registry name reads the official file name under `root`."""
    pt = tmp_path / "RN50.pt"
    synthesize.write_clip(str(pt), TCFG, seed=2, jit=False, dtype=torch.float32)
    from clip_glass_torch.weights import convert_clip

    tree, cfg = convert_clip.load_torch_checkpoint(str(pt))
    assert cfg == dataclasses.replace(TCFG) and cfg.vision_layers == (1, 1, 1, 1)
    pytree.save_npz(str(tmp_path / "rn.npz"), tree)
    with open(tmp_path / "rn_cfg.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    a, acfg = load.load_clip(str(pt))
    b, bcfg = load.load_clip(str(tmp_path / "rn.npz"))
    assert acfg == bcfg == cfg
    fa, fb = pytree.flatten(a), pytree.flatten(b)
    assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
    model = tapi.load("RN50", root=str(tmp_path), device="cpu")
    assert model.cfg == cfg
    torch.testing.assert_close(model.encode_image(_images(3)),
                               tclip.encode_image(a, T(_images(3)), cfg), rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        tapi.load("ViT-B/32", root=str(tmp_path), device="cpu")
    assert tapi.model_path("ViT-B/32", "w") == "w/ViT-B-32.pt"
