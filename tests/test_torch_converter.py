"""PyTorch port, the checkpoint converter (``utils/converter.py``) against
the JAX package's (``self_supervise_sfm_tpu/utils/converter.py``).

No checkpoint is downloaded: each state dict is built here, in the
reference's names, from JAX ``init_*`` param shapes filled with seeded
numpy values, by inverting the JAX converter's layout rules (linear
weights transposed back to (out, in), HWIO convs back to PyTorch's OIHW /
(in, out, kh, kw), stacked blocks split into ``name.i``, and the
reference's own names: ``global_reloc_blocks``, ``poseLN_modulation.1``,
``resize_layers.i``, ``output_conv2.0`` / ``.2``, ``*.0`` of the
Sequentials, ``virual_tracks``, ``in_proj_*`` / ``out_proj`` and
``cross_attn`` of ``nn.MultiheadAttention``, ``downsample.0``). On each
dict the port's tree must equal ``convert.from_jax_params`` of the JAX
converter's, leaf by leaf, bit-equal, with the same structure.

The demo's ``--pretrained`` and ``--tracker-weights`` load such dicts from
files: the demo's forward on the loaded weights is held against the JAX
forward on the JAX converter's weights of the same file (fp32 rounding,
``tests/test_torch_model.py``'s tolerance). The trainer's ``--pretrained``
is held against the JAX trainer in ``tests/test_torch_trainer.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.heads import track as JH
from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu.pipeline import extractors as JX
from self_supervise_sfm_tpu.pipeline import vggsfm_tracker as JV
from self_supervise_sfm_tpu.utils import converter as JC
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.pipeline import extractors as TX
from self_supervise_sfm_tpu_torch.pipeline import vggsfm_tracker as TV
from self_supervise_sfm_tpu_torch.utils import converter as TC
from tests.test_torch_tracker import small_cfg

torch.set_num_threads(1)

TINY = dict(img_size=28, embed_dim=64, depth=4, num_heads=4, vit_depth=2,
            intermediate_layer_idx=(0, 1, 2, 3), attn_impl="dense")
FP32_TOL = dict(rtol=2e-4, atol=1e-4)


def random_params(init_fn, seed=0):
    """numpy leaves in the structure ``init_fn`` builds (traced abstractly:
    no JAX random kernel compiles), with non-trivial norms and biases."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        x = rng.normal(size=s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "w" and len(s.shape) >= 2:
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


# -- the JAX tree in the reference's names ----------------------------------------------

_STACKED = {"frame_blocks", "global_blocks", "reloc_blocks", "blocks", "trunk"}
_LEAF = {"w": "weight", "b": "bias", "scale": "weight"}
_RENAMES = (
    (r"^aggregator\.vit\.", "aggregator.patch_embed."),
    (r"^aggregator\.reloc_blocks\.", "aggregator.global_reloc_blocks."),
    (r"\.poseLN_modulation\.", ".poseLN_modulation.1."),
    (r"\.resize(\d)\.", r".resize_layers.\1."),
    (r"\.output_conv2\.conv1\.", ".output_conv2.0."),
    (r"\.output_conv2\.conv2\.", ".output_conv2.2."),
    (r"(^|\.)(ffeat_updater|vis_predictor|conf_predictor)\.", r"\1\2.0."),
    (r"\.virtual_tracks$", ".virual_tracks"),
    (r"(updateformer\.\w+_blocks\.\d+)\.attn\.qkv\.(weight|bias)$", r"\1.attn.in_proj_\2"),
    (r"(updateformer\.\w+_blocks\.\d+)\.attn\.proj\.", r"\1.attn.out_proj."),
    (r"(space_(?:point2virtual|virtual2point)_blocks\.\d+)\.attn\.", r"\1.cross_attn."),
    (r"\.downsample\.", ".downsample.0."),
)


def _flat(node, name, out):
    if isinstance(node, dict):
        for k, v in node.items():
            if k in _STACKED:
                depth = jax.tree_util.tree_leaves(v)[0].shape[0]
                for i in range(depth):
                    _flat(jax.tree_util.tree_map(lambda a, i=i: a[i], v), f"{name}{k}.{i}.",
                          out)
            else:
                _flat(v, f"{name}{k}.", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flat(v, f"{name}{i}.", out)
    elif node is not None:
        key = name[:-1].rsplit(".", 1)[-1]
        a = np.asarray(node)
        if key == "w":
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
        out[name[:-1 - len(key)] + _LEAF.get(key, key)] = np.ascontiguousarray(a)


def reference_state_dict(tree, prefix: str = "") -> dict:
    """A JAX param tree (numpy leaves) -> a state dict in the reference's
    names and PyTorch layouts, the inverse of the JAX converter."""
    flat = {}
    _flat(tree, f"{prefix}." if prefix else "", flat)
    sd = {}
    for name, a in flat.items():
        for pat, rep in _RENAMES:
            name = re.sub(pat, rep, name)
        sd[name] = a
    return sd


def track_head_state_dict(tree, prefix: str) -> dict:
    """The TrackHead's layout: the DPT as ``feature_extractor``, the rest
    under ``tracker``."""
    fe = {"feature_extractor": tree["feature_extractor"]}
    rest = {k: v for k, v in tree.items() if k != "feature_extractor"}
    return {**reference_state_dict(fe, prefix),
            **reference_state_dict(rest, f"{prefix}.tracker")}


def _with_paths(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _with_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _with_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def assert_same_tree(got, want):
    """Same structure (keys, list lengths, None leaves), every leaf equal in
    dtype, shape and bits, and contiguous."""
    g, w = _with_paths(got), _with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if b is None:
            assert a is None, path
            continue
        assert torch.is_tensor(a) and a.is_contiguous(), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


# -- SailRecon --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sailrecon():
    cfg = JM.make_config(**TINY)
    jp = random_params(lambda: JM.init_sailrecon(jax.random.PRNGKey(0), cfg))
    return cfg, jp, reference_state_dict(jp)


def test_reference_names(sailrecon):
    """The dict carries the reference's names (a few that are easy to get
    wrong) and none of the JAX package's."""
    _, _, sd = sailrecon
    for name in ("aggregator.global_reloc_blocks.3.attn.q_norm.weight",
                 "aggregator.patch_embed.patch_embed.proj.weight",
                 "aggregator.patch_embed.blocks.1.ls2.gamma",
                 "camera_head.poseLN_modulation.1.weight",
                 "point_head.resize_layers.1.weight",
                 "depth_head.scratch.output_conv2.2.bias",
                 "camera_head.trunk.3.mlp.fc2.weight"):
        assert name in sd, name
    assert not any(k.endswith((".w", ".b", ".scale"))
                   or k.startswith(("aggregator.vit.", "aggregator.reloc_blocks.")) for k in sd)
    assert sd["aggregator.frame_blocks.0.attn.qkv.weight"].shape == (3 * 64, 64)


def test_convert_sailrecon_bit_equal_to_jax(sailrecon):
    _, jp, sd = sailrecon
    got = TC.convert_sailrecon(sd, depth=4, vit_depth=2)
    assert_same_tree(got, convert.from_jax_params(_np_tree(JC.convert_sailrecon(sd, 4, 2))))
    # and the dict inverts the JAX tree it came from
    assert_same_tree(got, convert.from_jax_params(jp))


def test_tensor_leaves_and_missing_register_tokens(sailrecon):
    """Tensor leaves (bf16 ones too) convert as numpy leaves do; a ViT with
    no ``register_tokens`` gives None, as JAX's."""
    _, _, sd = sailrecon
    sd = {k: v for k, v in sd.items() if not k.endswith("register_tokens")}
    want = convert.from_jax_params(_np_tree(JC.convert_sailrecon(sd, 4, 2)))
    assert want["aggregator"]["vit"]["register_tokens"] is None
    assert_same_tree(TC.convert_sailrecon({k: torch.from_numpy(v) for k, v in sd.items()},
                                          4, 2), want)
    bf = TC.convert_vit({k: torch.from_numpy(v).bfloat16() for k, v in sd.items()},
                        "aggregator.patch_embed", 2)
    assert bf["blocks"][1]["attn"]["qkv"]["w"].dtype == torch.bfloat16
    assert torch.equal(bf["blocks"][1]["attn"]["qkv"]["w"].float(),
                       want["aggregator"]["vit"]["blocks"][1]["attn"]["qkv"]["w"]
                       .bfloat16().float())


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_torch_state_dict(sailrecon, tmp_path, wrapped, dtype):
    """A bare dict or one in a ``state_dict`` wrapper; bf16 leaves come back
    in fp32, as the JAX loader's ``.float()`` gives them."""
    _, _, sd = sailrecon
    part = {k: torch.from_numpy(v).to(dtype) for k, v in list(sd.items())[:40]}
    path = tmp_path / "ckpt.pt"
    torch.save({"state_dict": part, "epoch": 3} if wrapped else part, path)
    got = TC.load_torch_state_dict(str(path))
    want = JC.load_torch_state_dict(str(path))
    assert list(got) == list(part) == list(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, part[k].float())
        np.testing.assert_array_equal(v.numpy(), want[k])


# -- the heads and the trackers -------------------------------------------------------------


def test_convert_track_head_bit_equal_to_jax():
    cfg = JH.TrackHeadConfig(dim_in=32, features=16, iters=2, corr_levels=3, corr_radius=2,
                             hidden_size=32, depth=2, intermediate_layer_idx=(0, 1, 2, 3))
    jp = random_params(lambda: JH.init_track_head(jax.random.PRNGKey(0), cfg))
    sd = track_head_state_dict(jp, "t")
    assert "t.tracker.updateformer.virual_tracks" in sd
    assert "t.tracker.updateformer.space_point2virtual_blocks.1.cross_attn.in_proj_weight" in sd
    assert "t.tracker.ffeat_updater.0.weight" in sd and "t.feature_extractor.norm.bias" in sd
    got = TC.convert_track_head(sd, "t", depth=2)
    assert_same_tree(got, convert.from_jax_params(_np_tree(JC.convert_track_head(sd, "t", 2))))
    assert_same_tree(got, convert.from_jax_params(jp))


def test_convert_vggsfm_tracker_bit_equal_to_jax():
    jcfg, tcfg = small_cfg(JV), small_cfg(TV)
    jp = random_params(lambda: JV.init_vggsfm_tracker(jax.random.PRNGKey(0), jcfg))
    sd = reference_state_dict(jp)
    assert "coarse_fnet.layer2.0.downsample.0.weight" in sd
    assert "coarse_predictor.updateformer.time_blocks.1.attn.out_proj.bias" in sd
    assert not any(".norm1." in k for k in sd)  # the dependency variant's affine-free norms
    got = TC.convert_vggsfm_tracker(sd, tcfg)
    assert_same_tree(got, convert.tracker_from_jax(_np_tree(JC.convert_vggsfm_tracker(sd, jcfg))))
    assert_same_tree(got, convert.tracker_from_jax(jp))


def test_convert_torch_superpoint_bit_equal_to_jax():
    jp = random_params(lambda: JX.init_superpoint(jax.random.PRNGKey(0)))
    sd = reference_state_dict(jp)
    assert sd["conv1a.weight"].shape == (64, 1, 3, 3)
    got = TX.convert_torch_superpoint(sd)
    assert_same_tree(got, convert.superpoint_from_jax(_np_tree(JX.convert_torch_superpoint(sd))))
    assert_same_tree(TX.convert_torch_superpoint({k: torch.from_numpy(v) for k, v in sd.items()}),
                     got)


# -- the demo's options ------------------------------------------------------------------------


class _Scenes:
    """One numpy scene of three 28 px frames."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return 1

    def load_scene(self, idx, rng):
        return {"images": self.images, "scene_name": "s0"}


def _demo_args(tmp_path, *extra):
    from self_supervise_sfm_tpu_torch.demos import reconstruct as TD

    return TD.parse_args(["--data-root", "unused", "--out-dir", str(tmp_path / "out"),
                          "--num-images", "3", "--img-size", "28", "--rank", "4",
                          "--num-scenes", "1", "--compute-dtype", "float32", "--depth", "4",
                          "--vit-depth", "2", "--device", "cpu", "--max-query-pts", "12",
                          *extra])


@pytest.fixture
def tiny_port_config(monkeypatch):
    """The demo's ``make_config`` at the tiny width (the demo has no width
    options)."""
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM

    orig = TM.make_config
    monkeypatch.setattr(TM, "make_config", lambda **kw: orig(**{**kw, **TINY}))


def test_demo_pretrained_forward_matches_jax(sailrecon, tmp_path, monkeypatch,
                                            tiny_port_config, rng):
    """``--pretrained``: the file through the port's loader and converter;
    the demo's forward (full rank: every token kept) against the JAX
    forward on the JAX converter's params of the same file."""
    from self_supervise_sfm_tpu_torch.demos import reconstruct as TD

    cfg, _, sd = sailrecon
    path = tmp_path / "sailrecon.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    images = rng.uniform(size=(3, 28, 28, 3)).astype(np.float32)
    got = []
    orig = TD.reconstruct_scene
    monkeypatch.setattr(TD, "reconstruct_scene",
                        lambda *a, **kw: got.append(orig(*a, **kw)) or got[-1])
    TD.run(_demo_args(tmp_path, "--pretrained", str(path)), _Scenes(images))
    jparams = JC.convert_sailrecon(JC.load_torch_state_dict(str(path)), 4, 2)
    dup = jnp.asarray(np.concatenate([images, images])[None])
    ref = jax.jit(lambda p, x: JM.forward(p, cfg, x, 3, 3, rank=4,
                                          subsample_key=jax.random.PRNGKey(0)))(jparams, dup)
    (out,) = got
    for k in ("extrinsic", "intrinsic", "point_map", "xyz_cnf", "depth_map", "dpt_cnf"):
        a, b = np.asarray(out[k], np.float32), np.asarray(ref[k])
        assert a.shape == b.shape, k
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
        np.testing.assert_allclose(a[fin], b[fin], err_msg=k, **FP32_TOL)


def test_demo_tracker_weights(tmp_path, monkeypatch, tiny_port_config, rng):
    """``--tracker-weights``: the VGGSfM tracker file through the port's
    loader and converter (at the small tracker config of
    ``tests/test_torch_tracker.py``); the demo tracks with exactly those
    weights, bit-equal to the JAX converter's of the same file (the port's
    tracker is held against JAX's on identical weights there)."""
    from self_supervise_sfm_tpu_torch.demos import reconstruct as TD
    from self_supervise_sfm_tpu_torch.pipeline import tracking as TT

    jcfg = small_cfg(JV, fine_iters=1)
    jp = random_params(lambda: JV.init_vggsfm_tracker(jax.random.PRNGKey(1), jcfg), seed=1)
    path = tmp_path / "vggsfm_v2_tracker.pt"
    torch.save({k: torch.from_numpy(v) for k, v in reference_state_dict(jp).items()}, path)
    tcfg = small_cfg(TV, fine_iters=1)
    monkeypatch.setattr(TV, "VGGSfMTrackerConfig", lambda: tcfg)
    used = []
    orig = TT.predict_tracks
    monkeypatch.setattr(TT, "predict_tracks",
                        lambda params, *a, **kw: used.append(params) or orig(params, *a, **kw))
    # a checkerboard: corners for the keypoint detector
    yy, xx = np.mgrid[:28, :28]
    board = (((yy // 4) + (xx // 4)) % 2).astype(np.float32)
    images = np.stack([np.roll(board, s, axis=1) for s in range(3)])[..., None].repeat(3, -1)
    images = 0.8 * images + 0.1 * rng.uniform(size=images.shape).astype(np.float32)
    TD.run(_demo_args(tmp_path, "--tracks-ba", "--tracker-weights", str(path)),
           _Scenes(images))
    assert used, "no tracker call"
    want = convert.tracker_from_jax(_np_tree(JC.convert_vggsfm_tracker(
        JC.load_torch_state_dict(str(path)), jcfg)))
    assert_same_tree(used[0], want)
