"""PyTorch port: aggregator and full SailRecon forward vs the JAX package.

The suite's tiny config (``tests/test_reloc_split.py:118-121``), weights
from the JAX ``init_sailrecon`` through ``convert.from_jax_params``,
explicit subsample indices, the duplicated anchor+query layout. The port
also runs with every kernel gate forced on, so the plain versions of the
attention and resize kernels run inside the model, and its bf16 trunk runs
the fused LN+QKV / out-proj / MLP route by default and the unfused chain on
request. Plus import hygiene and the device
rule of the entry points.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.models import aggregator as JA
from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.models import aggregator as TA
from self_supervise_sfm_tpu_torch.models import sailrecon as TM
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops import fused_qkv as TFQ
from self_supervise_sfm_tpu_torch.ops import resize as TRS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(img_size=28, embed_dim=64, depth=4, num_heads=4, vit_depth=2,
            intermediate_layer_idx=(0, 1, 2, 3))
A = Q = 3
RANK = 2
KEYS = ("extrinsic", "intrinsic", "point_map", "xyz_cnf", "depth_map", "dpt_cnf",
        "point_map_by_unprojection", "cam_tokens")
# fp32: both sides compute the same ops in fp32; differences are summation
# order (~1e-5 absolute on the head logits), amplified by the random-init
# heads' exp / inverse-log activations — relative where values are large
FP32_TOL = dict(rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    cfg = JM.make_config(**TINY)
    jp = jax.jit(lambda k: JM.init_sailrecon(k, cfg))(jax.random.PRNGKey(0))
    uniq = rng.uniform(size=(1, A, 28, 28, 3)).astype(np.float32)
    images = np.concatenate([uniq, uniq], axis=1)
    P0 = (28 // 14) ** 2
    idx = np.stack([rng.permutation(P0)[:RANK] for _ in range(4 * A)])
    idx = idx.reshape(4, 1, A, RANK).astype(np.int32)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    return dict(cfg=cfg, jp=jp, tp=tp, images=images, idx=idx)


def _jax_forward(s, cfg):
    fn = jax.jit(lambda p, x, i: JM.forward(
        JM.cast_trunk_weights(p, cfg), cfg, x, A, Q, rank=RANK,
        subsample_indices=i, images_duplicated=True))
    out = fn(s["jp"], jnp.asarray(s["images"]), jnp.asarray(s["idx"]))
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), out)


@pytest.fixture(scope="module")
def jax_fp32(setup):
    return _jax_forward(setup, setup["cfg"])


def _port_forward(s, **cfg_kw):
    cfg = TM.make_config(**TINY, **cfg_kw)
    p = TM.cast_trunk_weights(s["tp"], cfg)
    return TM.forward(p, cfg, s["images"], A, Q, rank=RANK,
                      subsample_indices=torch.from_numpy(s["idx"]),
                      images_duplicated=True, device="cpu")


def _compare(out, ref, **tol):
    for k in KEYS:
        a = out[k].float().numpy()
        b = ref[k]
        assert a.shape == b.shape, k
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
        np.testing.assert_allclose(a[fin], b[fin], err_msg=k, **tol)
    for a, b in zip(out["pose_enc_list"], ref["pose_enc_list"]):
        np.testing.assert_allclose(a.float().numpy(), b, **tol)


def test_aggregator_forward_matches_jax(setup):
    s = setup
    jcfg = s["cfg"].aggregator
    j_taps, j_psi, j_cam = jax.jit(lambda p, x, i: JA.aggregator_forward(
        p["aggregator"], jcfg, x, A, Q, RANK, subsample_indices=i,
        images_duplicated=True))(s["jp"], jnp.asarray(s["images"]), jnp.asarray(s["idx"]))
    tcfg = TM.make_config(**TINY).aggregator
    t_taps, t_psi, t_cam = TA.aggregator_forward(
        s["tp"]["aggregator"], tcfg, torch.from_numpy(s["images"]), A, Q, RANK,
        subsample_indices=torch.from_numpy(s["idx"]), images_duplicated=True)
    assert t_psi == j_psi
    assert sorted(t_taps) == sorted(j_taps)
    for k in j_taps:
        assert t_taps[k].dtype == torch.float32
        np.testing.assert_allclose(t_taps[k].numpy(), np.asarray(j_taps[k]), atol=1e-5,
                                   err_msg=str(k))
    np.testing.assert_allclose(t_cam.numpy(), np.asarray(j_cam), atol=1e-5)


def test_forward_matches_jax_fp32(setup, jax_fp32):
    _compare(_port_forward(setup), jax_fp32, **FP32_TOL)


def test_forward_with_kernel_gates_forced_matches_jax(setup, jax_fp32, monkeypatch):
    """attn_impl="flash", global_attn_impl="flash" and resize_impl="kernel":
    every attention site and
    every DPT upsample the kernel takes goes through the kernel wrappers,
    which on the CPU run the kernels' plain versions."""
    calls = {"flash_fwd": 0, "frame_ctx_fwd": 0, "resize_bilinear": 0}

    def spy(mod, name):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(TFA, "flash_fwd")
    spy(TFA, "frame_ctx_fwd")
    spy(TRS, "resize_bilinear")
    out = _port_forward(setup, attn_impl="flash", global_attn_impl="flash",
                        resize_impl="kernel")
    depth, vit_depth = TINY["depth"], TINY["vit_depth"]
    # ViT + frame + global sites; the reloc site per layer; per DPT head the
    # 2->4->8->16 refinenet upsamples and the final 16->28 (1->2 is no upsample
    # the kernel takes)
    assert calls == {"flash_fwd": vit_depth + 2 * depth, "frame_ctx_fwd": depth,
                     "resize_bilinear": 2 * 4}
    _compare(out, jax_fp32, **FP32_TOL)


def _max_err(a, b):
    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[fin] - b[fin]).max())


def _check_bf16_envelope(out, ref, jax_fp32):
    pairs = [(k, out[k].float().numpy(), ref[k], jax_fp32[k]) for k in KEYS]
    pairs += [(f"pose_enc_list[{i}]", a.float().numpy(), b, c) for i, (a, b, c) in
              enumerate(zip(out["pose_enc_list"], ref["pose_enc_list"],
                            jax_fp32["pose_enc_list"]))]
    for k, a, b, c in pairs:
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=k)
        assert _max_err(a, b) <= _max_err(b, c), k


@pytest.fixture(scope="module")
def jax_bf16(setup):
    return _jax_forward(setup, JM.make_config(compute_dtype="bfloat16", **TINY))


def test_forward_bf16_trunk_matches_jax(setup, jax_fp32, jax_bf16, monkeypatch):
    """bf16 trunk, fp32 heads, on both sides; the port on its default route,
    which for a bf16 trunk is the fused LN+QKV / out-proj / MLP functions
    (their plain versions on the CPU) in every ViT, frame, reloc and global
    block. The frameworks round to bf16 at the same points but sum in other
    orders, and the random-init camera adaLN and exp / inverse-log heads
    amplify each 2^-8 step. Tolerance: per output, the port's max error
    against JAX-bf16 stays within JAX's own bf16 envelope
    (max |JAX-bf16 - JAX-fp32|); finite masks agree."""
    calls = {}
    for name in ("fused_ln_qkv_rope", "fused_ln_qkv", "fused_proj_residual",
                 "fused_mlp_up", "fused_mlp_down"):
        calls[name] = 0

        def wrapped(*a, _orig=getattr(TFQ, name), _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(TFQ, name, wrapped)
    out = _port_forward(setup, compute_dtype="bfloat16")
    depth, vit_depth = TINY["depth"], TINY["vit_depth"]
    blocks = 3 * depth + vit_depth
    assert calls == {"fused_ln_qkv_rope": 3 * depth, "fused_ln_qkv": vit_depth,
                     "fused_proj_residual": blocks, "fused_mlp_up": blocks,
                     "fused_mlp_down": blocks}
    _check_bf16_envelope(out, jax_bf16, jax_fp32)


def test_forward_bf16_trunk_unfused_matches_jax(setup, jax_fp32, jax_bf16):
    """The same forward with ``fused_qkv="off", fused_mlp="off"``: the
    unfused chain of plain matmuls, held to the same envelope."""
    out = _port_forward(setup, compute_dtype="bfloat16", fused_qkv="off",
                        fused_mlp="off")
    _check_bf16_envelope(out, jax_bf16, jax_fp32)


def test_forward_fp32_fused_forced_matches_jax(setup, jax_fp32):
    """``fused_qkv="on", fused_mlp="on"`` in fp32: the fused functions'
    arithmetic in every trunk block, against the JAX fp32 forward."""
    _compare(_port_forward(setup, fused_qkv="on", fused_mlp="on"), jax_fp32, **FP32_TOL)


def _port_sources():
    files = sorted((ROOT / "self_supervise_sfm_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


# the trainer slice's modules, which the AST check below must reach
TRAINER_SLICE = ("data/preprocess.py", "data/synthetic.py", "data/imc2021.py",
                 "native/dataplane.py", "train/checkpoint.py", "train/metrics.py",
                 "train/validate.py", "train/trainer.py", "utils/export.py",
                 "utils/sanity_check.py", "utils/vls.py")


# the reconstruction demo's slice: geometry and I/O, bundle adjustment,
# tracking, the demo
DEMO_SLICE = ("ops/geometry.py", "utils/evaluation.py", "utils/colmap_io.py",
              "ops/bundle_adjust.py", "native/ba.py", "heads/track_utils.py",
              "heads/track_modules.py", "pipeline/vggsfm_tracker.py", "pipeline/extractors.py",
              "pipeline/tracking.py", "convert.py", "demos/reconstruct.py", "utils/vls.py",
              "utils/images.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "self_supervise_sfm_tpu")
    sources = _port_sources()
    for name in TRAINER_SLICE + DEMO_SLICE:
        assert ROOT / "self_supervise_sfm_tpu_torch" / name in sources, name
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in banned, f"{path.relative_to(ROOT)} imports {n}"


def test_trainer_imports_with_torch_and_numpy_alone():
    """h5py, PIL, matplotlib and tensorboardX are imported where they are
    used, never by importing the trainer (or any module it imports)."""
    import subprocess
    import sys

    code = ("import sys; import self_supervise_sfm_tpu_torch.train.trainer; "
            "print(sorted(m for m in ('h5py', 'PIL', 'matplotlib', 'tensorboardX', 'jax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_port_writes_nothing_under_cpp(tmp_path, monkeypatch):
    """The data plane's library builds into ``build/dataplane`` (and the
    bundle-adjustment engine's into ``build/ba``); no source of the port
    names a path under ``cpp/`` but the C++ sources it reads, and a forced
    build leaves ``cpp/`` as it was."""
    import subprocess

    from self_supervise_sfm_tpu_torch.native import dataplane as DP

    for path in _port_sources():
        for line in path.read_text().splitlines():
            if '"cpp"' in line:
                assert "_SRC" in line and ("dataplane.cpp" in line or "ba_engine.cpp" in line), \
                    f"{path}: {line}"
    assert DP._LIB == str(ROOT / "build" / "dataplane" / "libdataplane.so")
    assert DP._SRC == str(ROOT / "cpp" / "dataplane" / "dataplane.cpp")

    def tree(root):
        return sorted((str(p.relative_to(root)), p.stat().st_size, p.stat().st_mtime_ns)
                      for p in root.rglob("*"))

    before = tree(ROOT / "cpp")
    lib = tmp_path / "lib" / "libdataplane.so"
    monkeypatch.setattr(DP, "_LIB", str(lib))
    try:
        DP.build(force=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the data plane does not build here (g++ with libjpeg/libpng): {e}")
    assert lib.exists()
    assert tree(ROOT / "cpp") == before


def test_entry_points_refuse_to_fall_back_to_the_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TM.make_config(**TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.forward(setup["tp"], cfg, setup["images"], A, Q, rank=RANK,
                   subsample_indices=torch.from_numpy(setup["idx"]),
                   images_duplicated=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_sailrecon(cfg, torch.Generator().manual_seed(0))


def test_generator_draw_equals_explicit_indices(setup):
    """forward(generator=g) draws (depth, B, A, rank) patch indices with
    ``draw_subsample_indices``; passing that draw explicitly is the same run."""
    cfg = TM.make_config(**TINY)
    P0 = (28 // 14) ** 2
    idx = TA.draw_subsample_indices(cfg.aggregator, 1, A, P0, RANK,
                                    torch.Generator().manual_seed(3))
    assert idx.shape == (TINY["depth"], 1, A, RANK)
    assert all(len(set(row.tolist())) == RANK for row in idx.reshape(-1, RANK))
    kw = dict(rank=RANK, images_duplicated=True, device="cpu")
    a = TM.forward(setup["tp"], cfg, setup["images"], A, Q,
                   generator=torch.Generator().manual_seed(3), **kw)
    b = TM.forward(setup["tp"], cfg, setup["images"], A, Q, subsample_indices=idx, **kw)
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="generator"):
        TM.forward(setup["tp"], cfg, setup["images"], A, Q, **kw)


def test_init_sailrecon_matches_the_jax_tree(setup):
    """The port's own random init builds the same structure and shapes as
    the converted JAX params."""
    cfg = TM.make_config(**TINY)
    p = TM.init_sailrecon(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = setup["tp"]

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return None if t is None else tuple(t.shape)

    assert shapes(p) == shapes(ref)
