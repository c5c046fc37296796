"""The port's fused-MLP and W8A8 int8 GEMM ops against the JAX package, on the
CPU: the plain versions (which the wrappers take for CPU tensors) against the
Pallas kernels in interpret mode and against their plain-XLA references, on
inputs from numpy seeds. The CUDA kernels are held against the same plain
versions on the card (`tests/test_torch_flash_cuda.py`, `chip_smoke.py`).

Three sections of tests/test_torch_train.py follow, moved here whole (names,
bodies and tolerances unchanged) so that no file holds the tier-1 run's workers
back: SAP (its loss, train steps, bf16 dtypes, MAE transfer and CLI), varemb in
training, and trainer parity (validation, the mid-epoch resume, SIGTERM,
TensorBoard and the profiler, against the JAX trainer). They share that file's
helpers and tests/test_torch_flash.py's (where its UNETR and adaptive sections
went)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # xdist's workers share the cores: one torch
    torch.set_num_threads(1)  # thread each keeps them from oversubscribing the machine

from ucf_vit_tpu.ops import fused_mlp as jax_mlp
from ucf_vit_tpu.ops import int8_gemm as jax_int8
from ucf_vit_tpu_torch.ops.fused_mlp import (
    _padded_copy,
    fused_mlp,
    fused_mlp_plain,
    mlp_plan,
    mlp_plan_f32,
)
from ucf_vit_tpu_torch.ops.int8_gemm import (
    int8_matmul,
    int8_matmul_plain,
    int8_plan,
    quantize_rows,
    quantize_rows_plain,
    quantize_weight,
)

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# bf16: the JAX tests' own atol (one bf16 ulp of outputs below 4 is 1.6e-2: the
# two sides may round an output to neighbouring values). f32: sums in other orders.
MLP_TOL = {"bfloat16": 2e-2, "float32": 1e-5}


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(TORCH_DTYPES[dtype])


def _mlp_inputs(lead, d, h, dtype, seed=0):
    """The JAX tests' inputs (`tests/test_fused_mlp.py`), rounded to `dtype`."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=lead + (d,)), rng.normal(size=(d, h)) * 0.02,
              rng.normal(size=(h,)) * 0.01, rng.normal(size=(h, d)) * 0.02,
              rng.normal(size=(d,)) * 0.01]
    jax_args = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return jax_args, [_to_torch(a, dtype) for a in jax_args]


# (leading dims, D, H, block_m): the JAX tests' shapes
MLP_SHAPES = {"512x256x1024": ((512,), 256, 1024, 256), "ragged300x128x512": ((300,), 128, 512, 128),
              "lead2x70x128": ((2, 70), 128, 512, 128)}


@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", sorted(MLP_SHAPES))
def test_fused_mlp_plain_matches_jax(shape, dtype, approx):
    lead, d, h, bm = MLP_SHAPES[shape]
    jax_args, args = _mlp_inputs(lead, d, h, dtype)
    kernel = jax_mlp.fused_mlp(*jax_args, approx=approx, block_m=bm, interpret=True)
    reference = jax_mlp.fused_mlp_reference(*jax_args, approx=approx)
    plain = fused_mlp_plain(*args, approx=approx)
    wrapped = fused_mlp(*args, approx=approx)  # a CPU tensor takes the plain version
    assert plain.dtype == TORCH_DTYPES[dtype] and plain.shape == lead + (d,)
    assert torch.equal(plain, wrapped)
    for ref in (kernel, reference):
        np.testing.assert_allclose(plain.float().numpy(), np.asarray(ref, np.float32),
                                   atol=MLP_TOL[dtype], rtol=0)


def test_fused_mlp_rounds_the_hidden_to_the_input_dtype():
    """The hidden goes to bf16 before fc2, as in the TPU kernel (`:59`): an f32
    hidden would differ by more than the rounding of the output alone."""
    _, args = _mlp_inputs((64,), 128, 512, "bfloat16", seed=3)
    x, w1, b1, w2, b2 = args
    h = torch.nn.functional.gelu(x.float() @ w1.float() + b1.float(), approximate="tanh")
    rounded = (h.to(torch.bfloat16).float() @ w2.float() + b2.float()).to(torch.bfloat16)
    unrounded = (h @ w2.float() + b2.float()).to(torch.bfloat16)
    assert torch.equal(fused_mlp_plain(*args), rounded)
    assert not torch.equal(rounded, unrounded)


def test_fused_mlp_limits_and_no_backward():
    _, args = _mlp_inputs((8,), 64, 128, "float32")
    x, w1, b1, w2, b2 = args
    with pytest.raises(ValueError, match="D <= 1024"):
        fused_mlp(torch.zeros(4, 1152), torch.zeros(1152, 8), torch.zeros(8),
                  torch.zeros(8, 1152), torch.zeros(1152))
    with pytest.raises(ValueError, match="incompatible shapes"):
        fused_mlp(x, w1, b1, w2[:-1], b2)
    with pytest.raises(ValueError, match="x's dtype"):
        fused_mlp(x.bfloat16(), w1, b1, w2, b2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_mlp(*(t.half() for t in args))
    with pytest.raises(ValueError, match="at least one row"):
        fused_mlp(x[:0], w1, b1, w2, b2)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mlp(x, w1.clone().requires_grad_(), b1, w2, b2)
    with torch.no_grad():  # inference on parameters that require grad is fine
        assert fused_mlp(x, w1.clone().requires_grad_(), b1, w2, b2).shape == x.shape
    assert fused_mlp.launches == 0  # CPU calls launch no kernel


# mlp_plan on an H100 (132 SMs): (M, D, H, aligned) -> (route, D', H', blocks of a
# cluster, output warpgroups a block, S, blocks). ViT-B's MLP at batch 16 and ViT-L's at
# its microbatch of 8 take clusters of two (each block half of D's columns); ragged D or H,
# or a misaligned x, takes the padded route; a small M splits H into many slices.
MLP_PLANS = {
    "vit_b": ((4112, 768, 3072, True), ("tma", 768, 3072, 2, 2, 1, 130)),
    "vit_l": ((2056, 1024, 4096, True), ("tma", 1024, 4096, 2, 2, 2, 132)),
    "ragged": ((100, 200, 300, True), ("padded", 200, 304, 1, 1, 5, 10)),
    "m_below_64": ((50, 768, 3072, True), ("tma", 768, 3072, 2, 2, 48, 96)),
    "odd_d": ((300, 201, 512, True), ("padded", 208, 512, 1, 1, 8, 40)),
    "misaligned_x": ((4112, 768, 3072, False), ("padded", 768, 3072, 2, 2, 1, 130)),
}


@pytest.mark.parametrize("case", sorted(MLP_PLANS))
def test_mlp_plan_at_the_cards_shapes(case):
    (m, d, h, aligned), (route, d_pad, h_pad, groups, warpgroups, splits, blocks) = MLP_PLANS[case]
    plan = mlp_plan(m, d, h, 132, aligned)
    assert (plan.route, plan.d_pad, plan.h_pad, plan.groups, plan.warpgroups, plan.splits,
            plan.blocks) == (route, d_pad, h_pad, groups, warpgroups, splits, blocks)
    # what the kernel's C entry checks: the warpgroups cover a block's columns, every
    # slice of H gets at least one 64-unit chunk, one block per SM at most
    assert plan.group_cols % 64 == 0 and plan.groups * plan.group_cols >= plan.d_pad
    assert 256 * (plan.warpgroups - 1) < plan.group_cols <= 256 * plan.warpgroups
    chunks = -(-plan.h_pad // 64)
    assert (plan.splits - 1) * -(-chunks // plan.splits) < chunks
    assert plan.blocks == plan.row_tiles * plan.groups * plan.splits <= 132


def _padded_args(args, plan):
    """The padded route's copies (`ops/fused_mlp.py`): D and H zero-padded to D', H'."""
    x, w1, b1, w2, b2 = args
    dp, hp = plan.d_pad, plan.h_pad
    return (_padded_copy(x, (x.shape[0], dp)), _padded_copy(w1, (dp, hp)), _padded_copy(b1, (hp,)),
            _padded_copy(w2, (hp, dp)), _padded_copy(b2, (dp,)))


@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("shape", [(100, 200, 300), (33, 97, 61)], ids=str)
def test_fused_mlp_padded_route_is_exact(shape, approx):
    """Zero padding adds only zero terms: a zero hidden unit is gelu(0 + 0) = 0 and meets
    zero rows of w2, and the zero columns of x meet zero rows of w1. Bit-equal results
    cannot be asked: the CPU BLAS blocks its f32 sum over K by K's length, so a padded K
    (H 300 -> 304) adds the same terms in another order (1 and 3 of 20,000 bf16 outputs
    differ at (100, 200, 300) on one machine, none on another). So each output is held to
    what two roundings to bf16 of two f32 sums of the same terms can differ by: the larger
    of the two outputs' bf16 ulps, plus 2 (H' + 1) 2^-24 sum |terms| (each order's f32
    error bound, the bias add included), which matters only where the sum cancels to far
    below its terms (one erf output of 9.1e-7 moves by 2 of its ulps, 7.5e-9). A wrong
    padding would move outputs by whole products of a hidden unit and a weight, some
    1e-3. The columns past D are exactly zero, and at the ragged shape the result is held
    against the Pallas kernel in interpret mode."""
    m, d, h = shape
    plan = mlp_plan(m, d, h, 132)
    assert plan.route == "padded"
    jax_args, args = _mlp_inputs((m,), d, h, "bfloat16", seed=4)
    want = fused_mlp_plain(*args, approx=approx)
    padded = fused_mlp_plain(*_padded_args(args, plan), approx=approx)
    assert padded.shape == (m, plan.d_pad)
    x, w1, b1, w2, b2 = (t.float() for t in args)
    hidden = torch.nn.functional.gelu(x @ w1 + b1, approximate="tanh" if approx else "none")
    terms = (hidden.to(torch.bfloat16).float().abs() @ w2.abs() + b2.abs()).numpy()
    ref, got = want.float().numpy(), padded[:, :d].float().numpy()
    reorder = 2 * (plan.h_pad + 1) * 2.0**-24 * terms
    assert np.all(np.abs(got - ref) <= np.maximum(_one_bf16_ulp(ref), _one_bf16_ulp(got)) + reorder)
    assert not padded[:, d:].any()  # columns past D: zero weights and b2's zeros
    if shape == (100, 200, 300):
        kernel = jax_mlp.fused_mlp(*jax_args, approx=approx, block_m=128, interpret=True)
        np.testing.assert_allclose(padded[:, :d].float().numpy(), np.asarray(kernel, np.float32),
                                   atol=MLP_TOL["bfloat16"], rtol=0)


# mlp_plan_f32 on an H100 (132 SMs): (M, D, H) -> (blocks of a cluster, columns a block,
# ring stages, shared memory bytes, S, row tiles, blocks). A block takes at most 384 of D's
# columns, so ViT-B's D = 768 takes clusters of two and ViT-L's D = 1024 clusters of three
# (99 blocks: 33 clusters of three fit at once, where 33 of four would not); ragged D and
# H, M below one tile and D no multiple of 4 take a small cluster and split H. The f32
# kernel reads every shape and alignment as it is (4-byte copies where 16-byte ones do not
# fit), so a misaligned x has the aligned plan: the case shows there is no padded route.
MLP_PLANS_F32 = {
    "vit_b": ((4112, 768, 3072), (2, 384, 2, 227840, 1, 65, 130)),
    "vit_l": ((2056, 1024, 4096), (3, 384, 2, 227840, 1, 33, 99)),
    "ragged": ((100, 200, 300), (1, 256, 6, 217600, 5, 2, 10)),
    "m_below_64": ((50, 768, 3072), (2, 384, 2, 227840, 48, 1, 96)),
    "odd_d": ((300, 201, 509), (1, 256, 6, 217600, 8, 5, 40)),
    "misaligned_x": ((4112, 768, 3072), (2, 384, 2, 227840, 1, 65, 130)),
    "d1024_small_m": ((130, 1024, 4096), (3, 384, 2, 227840, 13, 3, 117)),
    "d512": ((4112, 512, 2048), (2, 256, 5, 231936, 1, 65, 130)),
}


@pytest.mark.parametrize("case", sorted(MLP_PLANS_F32))
def test_mlp_plan_f32_at_the_cards_shapes(case):
    (m, d, h), want = MLP_PLANS_F32[case]
    plan = mlp_plan_f32(m, d, h, 132)
    assert tuple(plan) == want
    # what the kernel's C entry checks: G = ceil(D / 384) blocks of a cluster, whose
    # slices of 128-column steps cover D; every slice of H gets at least one 64-unit
    # chunk; one block per SM at most; the shared memory within the 227 KB a block may
    # have, with at least two ring stages
    assert plan.groups == -(-d // 384) and plan.group_cols % 128 == 0
    assert plan.groups * plan.group_cols >= d and plan.group_cols <= 384
    assert (plan.groups - 1) * plan.group_cols < d  # no block without columns
    chunks = -(-h // 64)
    assert (plan.splits - 1) * -(-chunks // plan.splits) < chunks
    assert plan.blocks == plan.row_tiles * plan.groups * plan.splits <= 132
    assert plan.smem <= 232448 and plan.stages >= 2


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32, ties away from zero (tf32x3.cuh's `to_tf32`)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32: what the tensor cores read of an f32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as csrc/fused_mlp_tf32.cu computes it: each operand split as hi (rounded) +
    lo (read truncated), lo.hi + hi.lo + hi.hi, each TF32 product exact in f32."""
    a_hi, b_hi = _tf32_round(a), _tf32_round(b)
    a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _fused_mlp_tf32_emulated(x, w1, b1, w2, b2, approx, mm=_mm_3xtf32):
    """The f32 kernel's arithmetic in plain PyTorch: D split into the plan's slices; in
    each block the first product's 16-column k-groups taken alternately by two k-groups
    of warps whose partials are summed, the blocks' partials summed in rank order; + b1
    and the GELU; then the second product 16 hidden units at a time, each group's
    product summed from zero and added to y (the kernel's `product2_add`), + b2."""
    d, h = w1.shape
    plan = mlp_plan_f32(x.shape[0], d, h, 132)
    dk = plan.group_cols
    pre = None
    for r in range(plan.groups):
        k16 = [list(range(c, c + 16)) for c in range(r * dk, (r + 1) * dk, 16)]
        halves = [[c for group in k16[kg::2] for c in group if c < d] for kg in (0, 1)]
        part = mm(x[:, halves[0]], w1[halves[0]]) + mm(x[:, halves[1]], w1[halves[1]])
        pre = part if pre is None else pre + part
    hidden = torch.nn.functional.gelu(pre + b1, approximate="tanh" if approx else "none")
    y = torch.zeros(x.shape[0], d)
    for k0 in range(0, h, 16):
        y = y + mm(hidden[:, k0:k0 + 16], w2[k0:k0 + 16])
    return y + b2


# the card's limit for f32 fused_mlp against its plain version (chip_smoke.py,
# tests/test_torch_flash_cuda.py): sums in other orders over up to 4096 terms
CARD_F32_TOL = 1e-4


@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("shape", [(64, 768, 3072), (40, 1024, 4096)], ids=str)
def test_fused_mlp_3xtf32_split_keeps_f32_accuracy(shape, approx):
    """Why the f32 kernel keeps the card's f32 limit: at ViT-B's and ViT-L's widths (D
    split over clusters of two and three blocks) both products by the 3xTF32 split land
    within a tenth of CARD_F32_TOL of fused_mlp_plain and of the JAX package's
    fused_mlp_reference, while one TF32 pass a product misses the limit itself."""
    m, d, h = shape
    jax_args, args = _mlp_inputs((m,), d, h, "float32", seed=5)
    got = _fused_mlp_tf32_emulated(*args, approx)
    plain = fused_mlp_plain(*args, approx=approx)
    reference = np.asarray(jax_mlp.fused_mlp_reference(*jax_args, approx=approx), np.float32)
    assert (got - plain).abs().max().item() <= CARD_F32_TOL / 10
    np.testing.assert_allclose(got.numpy(), reference, atol=CARD_F32_TOL / 10, rtol=0)
    one_pass = _fused_mlp_tf32_emulated(
        *args, approx, mm=lambda a, b: _tf32_round(a) @ _tf32_round(b))
    assert (one_pass - plain).abs().max().item() > CARD_F32_TOL


# ---------------------------------------------------------------- int8


def _int8_inputs(m=96, k=256, n=256, seed=0, dtype="bfloat16"):
    """The JAX tests' inputs (`tests/test_int8_gemm.py`)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(m, k)), getattr(jnp, dtype))
    w = jnp.asarray(rng.normal(size=(k, n)) * 0.02, jnp.float32)
    return x, w


@pytest.mark.parametrize("shape", [(256, 256), (768, 2304), (3072, 768)], ids=str)
def test_quantize_weight_matches_jax(shape):
    _, w = _int8_inputs(k=shape[0], n=shape[1], seed=1)
    ref_i8, ref_scale = jax_int8.quantize_weight(w)
    w_i8, scale = quantize_weight(torch.from_numpy(np.asarray(w)))
    assert w_i8.dtype == torch.int8 and scale.dtype == torch.float32
    assert w_i8.shape == shape and scale.shape == (shape[1],)
    np.testing.assert_array_equal(w_i8.numpy(), np.asarray(ref_i8))
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale), rtol=1e-7, atol=0)


def _one_bf16_ulp(ref):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(96, 256, 256), (50, 256, 512), (130, 768, 512)], ids=str)
def test_int8_matmul_plain_matches_jax(shape, dtype):
    """Against the Pallas kernel (interpret mode, which `int8_matmul` takes on
    the CPU by itself) and the XLA reference. The same xq on all sides shows
    in the f32 output: integer sums are exact, so the only room is the last
    bit of `scale` (XLA may multiply by 1/127 where torch divides) and of the
    two products of the epilogue: 1e-6 relative. One xq element off by one
    would move an output by a 127th of a typical term, some 1e-3 relative."""
    m, k, n = shape
    x, w = _int8_inputs(m, k, n, seed=2, dtype=dtype)
    w_i8, ws = jax_int8.quantize_weight(w)
    tx = _to_torch(x, dtype)
    tw, tws = torch.from_numpy(np.asarray(w_i8)), torch.from_numpy(np.asarray(ws))
    for out_dtype in ("float32", "bfloat16"):
        kernel = jax_int8.int8_matmul(x, w_i8, ws, block_m=32, block_n=128,
                                      out_dtype=getattr(jnp, out_dtype))
        reference = jax_int8.int8_matmul_reference(x, w_i8, ws, getattr(jnp, out_dtype))
        plain = int8_matmul_plain(tx, tw, tws, TORCH_DTYPES[out_dtype])
        wrapped = int8_matmul(tx, tw, tws, out_dtype=TORCH_DTYPES[out_dtype])
        assert plain.dtype == TORCH_DTYPES[out_dtype] and plain.shape == (m, n)
        assert torch.equal(plain, wrapped)
        got = plain.float().numpy()
        for ref in (np.asarray(kernel, np.float32), np.asarray(reference, np.float32)):
            if out_dtype == "float32":
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).mean())
            else:
                assert np.all(np.abs(got - ref) <= _one_bf16_ulp(ref))
    assert int8_matmul(tx, tw, tws).dtype == TORCH_DTYPES[dtype]  # default: x's dtype


def _int8_matmul_plain_before_the_split(x, w_i8, wscale, out_dtype):
    """`int8_matmul_plain` as it was before `quantize_rows_plain` was split out of it."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    row_scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    xq = torch.round(xf / row_scale).clamp_(-127, 127)
    acc = (xq.to(torch.int32) @ w_i8.to(torch.int32)).float()
    return (acc * row_scale * wscale.float()[None, :]).to(out_dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(96, 256, 256), (50, 256, 512), (130, 768, 512)], ids=str)
def test_int8_matmul_plain_unchanged_by_the_split(shape, dtype):
    """Splitting the quantization out of the plain version moved no bit of its results, in
    either output type."""
    m, k, n = shape
    x, w = _int8_inputs(m, k, n, seed=2, dtype=dtype)
    tx = _to_torch(x, dtype)
    w_i8, ws = quantize_weight(torch.from_numpy(np.asarray(w)))
    for out_dtype in TORCH_DTYPES.values():
        assert torch.equal(int8_matmul_plain(tx, w_i8, ws, out_dtype),
                           _int8_matmul_plain_before_the_split(tx, w_i8, ws, out_dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(96, 256), (130, 768)], ids=str)
def test_quantize_rows_plain_matches_jax(shape, dtype):
    """Against the JAX package's own quantization steps (the `jnp` expressions of
    `int8_matmul_reference`, `ucf_vit_tpu/ops/int8_gemm.py:127-131`). xq is equal; the
    scale within 1e-7 relative, since XLA may take `/ 127.0` as a product by the rounded
    reciprocal where torch and the kernel divide (one f32 ulp is 6e-8 to 1.2e-7 relative)."""
    x, _ = _int8_inputs(m=shape[0], k=shape[1], seed=5, dtype=dtype)
    xf = jnp.asarray(x, jnp.float32)
    row_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-8) / 127.0
    ref_q = jnp.clip(jnp.round(xf / row_scale), -127, 127).astype(jnp.int8)
    xq, scale = quantize_rows_plain(_to_torch(x, dtype))
    assert xq.dtype == torch.int8 and xq.shape == shape
    assert scale.dtype == torch.float32 and scale.shape == (shape[0],)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_q))
    np.testing.assert_allclose(scale.numpy(), np.asarray(row_scale)[:, 0], rtol=1e-7, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_rows_pads_k_and_takes_a_zero_row(dtype):
    """`quantize_rows` (the kernel's workspace layout; the plain version on the CPU) pads
    K = 250 to the 128-byte K slice with zeros, and its first K columns are
    `quantize_rows_plain`'s. A zero row quantizes to zeros with the scale 1e-8 / 127."""
    x, _ = _int8_inputs(m=9, k=250, seed=6, dtype=dtype)
    tx = _to_torch(x, dtype)
    tx[4] = 0
    xq, scale = quantize_rows(tx)
    want_q, want_scale = quantize_rows_plain(tx)
    assert xq.shape == (9, 256) and xq.dtype == torch.int8
    assert torch.equal(xq[:, :250], want_q) and not xq[:, 250:].any()
    assert torch.equal(scale, want_scale)
    assert not xq[4].any() and scale[4] == torch.tensor(1e-8) / torch.tensor(127.0)
    assert quantize_rows(tx[:, :128])[0].shape == (9, 128)  # a whole slice: no padding
    assert quantize_rows.launches == 0  # CPU calls launch no kernel


# int8_plan on an H100 (132 SMs): (M, K, N, bytes of a y element) -> (Kp, M tiles, N
# tiles, tiles, persistent blocks, route of y). ViT-B's qkv, proj, fc1 and fc2 at batch 16
# (proj and fc2 fill 99 SMs of 132), and the card tests' M = 1 and ragged K and N shapes: a
# bf16 row of 132 or 260 columns is no multiple of 16 bytes, an f32 row of 132 is.
INT8_PLANS = {
    "vit_b_qkv": ((4112, 768, 2304, 2), (768, 33, 9, 297, 132, "tma")),
    "vit_b_proj": ((4112, 768, 768, 2), (768, 33, 3, 99, 99, "tma")),
    "vit_b_fc1": ((4112, 768, 3072, 2), (768, 33, 12, 396, 132, "tma")),
    "vit_b_fc2": ((4112, 3072, 768, 2), (3072, 33, 3, 99, 99, "tma")),
    "one_row": ((1, 768, 2304, 2), (768, 1, 9, 9, 9, "tma")),
    "ragged_k_n132_bf16": ((33, 250, 132, 2), (256, 1, 1, 1, 1, "direct")),
    "ragged_k_n132_f32": ((33, 250, 132, 4), (256, 1, 1, 1, 1, "tma")),
    "k6144_n260": ((200, 6144, 260, 2), (6144, 2, 2, 4, 4, "direct")),
}


@pytest.mark.parametrize("case", sorted(INT8_PLANS))
def test_int8_plan_at_the_cards_shapes(case):
    (m, k, n, out_bytes), want = INT8_PLANS[case]
    plan = int8_plan(m, k, n, 132, out_bytes)
    assert (plan.kp, plan.m_tiles, plan.n_tiles, plan.tiles, plan.grid, plan.route) == want
    # what the kernels' C entries check: xq and wt rows of whole 128-byte slices, every
    # block has a tile, TMA stores only for rows of y of whole 16-byte units
    assert plan.kp % 128 == 0 and k <= plan.kp < k + 128
    assert 1 <= plan.grid <= min(plan.tiles, 132)
    assert plan.route == "direct" or n * out_bytes % 16 == 0


def test_int8_matmul_near_exact_gemm():
    """The JAX test's bands (`tests/test_int8_gemm.py:44-55`)."""
    x, w = _int8_inputs()
    tx, tw = _to_torch(x, "bfloat16"), torch.from_numpy(np.asarray(w))
    y_q = int8_matmul(tx, *quantize_weight(tw), out_dtype=torch.float32).numpy()
    y_exact = np.asarray(x, np.float32) @ np.asarray(w, np.float32)
    rel = np.abs(y_q - y_exact) / (np.abs(y_exact).mean() + 1e-6)
    assert np.median(rel) < 0.02 and np.mean(rel) < 0.05


def test_int8_matmul_rows_are_independent():
    """Every row is quantized alone over the full K: `y[:33]` does not depend
    on M (the JAX `test_row_padding`)."""
    x, w = _int8_inputs(m=50)
    tx = _to_torch(x, "bfloat16")
    w_i8, ws = quantize_weight(torch.from_numpy(np.asarray(w)))
    y = int8_matmul(tx, w_i8, ws)
    assert y.shape == (50, 256)
    assert torch.equal(int8_matmul(tx[:33], w_i8, ws), y[:33])
    assert torch.equal(int8_matmul(tx[32:33], w_i8, ws), y[32:33])


def test_int8_matmul_limits():
    x = torch.zeros(8, 64)
    w_i8, ws = quantize_weight(torch.ones(64, 32))
    with pytest.raises(ValueError, match="incompatible shapes"):
        int8_matmul(x[:, :32], w_i8, ws)  # K mismatch
    with pytest.raises(ValueError, match="multiple of 4"):
        int8_matmul(x, w_i8[:, :30], ws[:30])
    with pytest.raises(ValueError, match="K <= 6144"):
        int8_matmul(torch.zeros(2, 8192), *quantize_weight(torch.ones(8192, 4)))
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(x, w_i8.float(), ws)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_matmul(x.half(), w_i8, ws)
    with pytest.raises(ValueError, match="at least one row"):
        int8_matmul(x[:0], w_i8, ws)
    assert int8_matmul(x, w_i8, ws).abs().max() == 0  # an all-zero row: scale 1e-8 / 127
    assert int8_matmul.launches == 0  # CPU calls launch no kernel


# ================================================================ moved from test_torch_train.py
# Its SAP and varemb-in-training sections, moved whole (names, bodies and tolerances
# unchanged) to spread the tier-1 run's files over its workers.

import jax

from flax.core import meta
from ucf_vit_tpu.checkpoint import transfer_mae_encoder as jax_transfer_mae_encoder
from ucf_vit_tpu.models.mae import MAE as JMAE
from ucf_vit_tpu.ops.attention import AttnImpl as JAttnImpl
from ucf_vit_tpu.parallel.train_step import TrainState as JTrainState
from ucf_vit_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ucf_vit_tpu.tasks import _seq_ps as jax_seq_ps
from ucf_vit_tpu.tasks import build_classification as jax_build_classification
from ucf_vit_tpu.tasks import reassemble_sqrt_len as jax_reassemble
from ucf_vit_tpu.utils import optim as jax_optim
from ucf_vit_tpu_torch import checkpoint as ckpt
from ucf_vit_tpu_torch.checkpoint import transfer_mae_encoder
from ucf_vit_tpu_torch.convert import jax_to_torch_state, load_jax_params
from ucf_vit_tpu_torch.ops.pos_embed import interpolate_pos_embed_1d
from ucf_vit_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ucf_vit_tpu_torch.tasks import build_task
from ucf_vit_tpu_torch.tasks import task_loss
from ucf_vit_tpu_torch.train import init_train
from ucf_vit_tpu_torch.train import main, to_device
from ucf_vit_tpu_torch.train import train
from ucf_vit_tpu_torch.train import transfer_pretrained_mae
from ucf_vit_tpu_torch.utils import optim
from test_torch_flash import _labelled_volumes  # its octree and UNETR section
from test_torch_flash import _adaptive_batches, _adaptive_raw  # its adaptive section
from test_torch_train import (  # shared with that file
    LOSS_TOL,
    _mae_noise,
    _mae_optimizer,
)

# ---------------------------------------------------------------- SAP
#
# basic_ct/sap and sap_bf16 shrunk (tile 16^3 at patch 2, 64 octree tokens reassembled
# into an 8^3 image, two blocks of 24 wide, batch 2): the loss on injected batches
# within 1e-6 of the JAX one, five train steps within 1e-4 (f32) and 5e-3 (bf16) a
# step, sap_bf16's dtypes from the token embed to the loss against `jax.eval_shape` of
# the JAX model, the MAE-encoder transfer into SAP, and the CLI: synthetic, and from
# labelled NIfTI volumes warm-started from an MAE checkpoint.

from ucf_vit_tpu.tasks import build_sap as jax_build_sap
from ucf_vit_tpu_torch.models import SAP

SAP_STEPS = 5
SAP_LOSS_TOL = 1e-6  # one loss on the same weights, f32
SAP_BF16_LOSS_TOL = 5e-3  # per-step loss, bf16


def _sap_raw(name="sap", twoD=False, **trainer):
    """basic_ct/<name> as shipped, shrunk (its task, dtype, adaptive octree input and the
    position MLP kept); `twoD` a 2-D copy (16 quadtree tokens of 2^2 into an 8^2 image)."""
    with open(os.path.join(REPO, "configs", "basic_ct", name, "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["net"]["init_args"].update(
        tile_size=[16, 16] if twoD else [16, 16, 16], patch_size=2,
        fixed_length=16 if twoD else 64, embed_dim=24, depth=2, num_heads=2, twoD=twoD)
    raw["model"].update(lr=1e-3, warmup_steps=2, max_steps=20, weight_decay=1e-5,
                        warmup_start_lr=1e-8, eta_min=1e-8)  # YAML reads 1e-5 as a string
    raw["trainer"].update(attn_impl="EINSUM", max_epochs=1, **trainer)
    raw["parallelism"] = {}
    raw["data"]["batch_size"] = 2
    return raw


def _sap_jax(raw, batch, seed=0):
    """The JAX SAP of `raw`, its loss and its params initialised on `batch`."""
    jmod, jloss = jax_build_sap(JConfig(raw=raw, task="sap"))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    twoD = raw["model"]["net"]["init_args"]["twoD"]
    img = jax_reassemble(b["seq"], 4, 2, twoD)
    params = meta.unbox(jmod.init(jax.random.key(seed), img, None, jax_seq_ps(b))["params"])
    return jmod, jloss, jax.tree.map(jnp.asarray, params)


def _sap_batches(cfg, n):
    return [{k: v for k, v in b.items() if k != "variables"}
            for _, b in zip(range(n), synthetic_batches(cfg, 2))]


@pytest.mark.parametrize("twoD", [False, True], ids=["3d", "2d"])
def test_sap_loss_matches_jax(twoD):
    """`dice_b_loss` of the logits of the reassembled image against the reassembled,
    one-hot serialized labels, on the same weights and batch."""
    raw = _sap_raw(twoD=twoD)
    cfg = Config(raw=raw, task="sap")
    b = _sap_batches(cfg, 1)[0]
    assert b["seq_label"].shape == (2, 16 if twoD else 64) + (2,) * (2 if twoD else 3)
    jmod, jloss, params = _sap_jax(raw, b)
    want, _ = jloss(params, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(0),
                    deterministic=True)
    model = load_jax_params(build_task(cfg), jax.device_get(params)).eval()
    assert isinstance(model, SAP) and model.token_grid == (4,) * (2 if twoD else 3)
    got, aux = task_loss(cfg)(model, to_device(b, torch.device("cpu")))
    assert aux == {} and got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= SAP_LOSS_TOL


@pytest.mark.parametrize("name, tol", [("sap", LOSS_TOL), ("sap_bf16", SAP_BF16_LOSS_TOL)])
def test_sap_train_steps_match_jax(name, tol):
    """Five steps from one JAX init on the synthetic stream (`seq`, `seq_size`,
    `seq_pos`, `seq_label`), the port's attention FLASH: the losses within `tol` a
    step, and falling."""
    raw = _sap_raw(name)
    cfg = Config(raw=raw, task="sap")
    batches = _sap_batches(cfg, SAP_STEPS)
    jmod, jloss, params = _sap_jax(raw, batches[0])
    assert jmod.dtype == (jnp.bfloat16 if name == "sap_bf16" else None)
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(jloss, tx, donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task="sap")
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(task_loss(cfg), opt)
    losses = [step(state, to_device(b, torch.device("cpu")))[1].item() for b in batches]
    np.testing.assert_allclose(losses, jax_losses, atol=tol, rtol=0)
    assert state.step == SAP_STEPS and losses[-1] < losses[0]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_sap_bf16_dtypes_match_jax_eval_shape():
    """Under the bf16 policy, the output type of each stage from the token embed to
    the loss against `jax.eval_shape` of the JAX model's captured intermediates: the
    embed and the blocks bf16, the position MLP f32 (cast to the stream after it), and
    from the final norm on f32, since the norm, the neck and the head take no dtype."""
    raw = _sap_raw("sap_bf16")
    cfg = Config(raw=raw, task="sap")
    b = _sap_batches(cfg, 1)[0]
    jmod, jloss, params = _sap_jax(raw, b)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    img = jax_reassemble(jb["seq"], 4, 2, False)

    def fwd(p):
        return jmod.apply({"params": p}, img, None, jax_seq_ps(jb), capture_intermediates=True,
                          mutable=["intermediates"])

    logits, inter = jax.eval_shape(fwd, params)
    inter = inter["intermediates"]
    stages = {"token_embed": "token_embeds", "adaptive_pos_dep_emb": "adaptive_pos_dep_emb",
              "blocks_1": "blocks.1", "norm": "norm", "neck": "neck",
              "mask_header": "mask_header"}
    want = {n: _dtype_name(inter[j]["__call__"][0].dtype) for j, n in stages.items()}
    want["logits"] = _dtype_name(logits.dtype)
    want["loss"] = _dtype_name(jax.eval_shape(
        lambda p: jloss(p, jb, jax.random.key(0))[0], params).dtype)

    model = load_jax_params(build_task(cfg), jax.device_get(params))
    got = {}
    for name in stages.values():
        model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(name, _dtype_name(o.dtype)))
    tb = to_device(b, torch.device("cpu"))
    loss, _ = task_loss(cfg)(model, tb)
    got["loss"] = _dtype_name(loss.dtype)
    from ucf_vit_tpu_torch.tasks import sap_inputs

    got["logits"] = _dtype_name(model(*sap_inputs(cfg, tb)).dtype)
    assert got == want
    assert want["blocks.1"] == "bfloat16" and want["neck"] == "float32"


def _mae_for_sap():
    """A JAX MAE (tile 16^3, patch 2: 512 tokens) with the shrunk SAP's encoder width
    and depth, and that SAP, each flax-initialised."""
    raw = _sap_raw()
    b = _sap_batches(Config(raw=raw, task="sap"), 1)[0]
    _, _, sparams = _sap_jax(raw, b, seed=1)
    jmae = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, img_size=(16, 16, 16),
                patch_size=2, in_chans=1, twoD=False, embed_dim=24, depth=2, num_heads=2,
                decoder_embed_dim=18, decoder_depth=1, decoder_num_heads=3)
    mparams = meta.unbox(jmae.init(jax.random.key(2), jnp.asarray(b["x"]),
                                   mask_noise=jnp.asarray(_mae_noise(2, 512)))["params"])
    return jax.device_get(mparams), jax.device_get(sparams), raw


def test_transfer_mae_encoder_into_sap_matches_jax():
    """The encoder's entries from the MAE (the position table resampled from 512 rows
    to SAP's 64), the neck, the head and the position MLP SAP's own."""
    mparams, sparams, _ = _mae_for_sap()
    want = jax_to_torch_state(jax_transfer_mae_encoder(mparams, sparams, new_pos_embed_len=64))
    mae_sd = {k: torch.from_numpy(v.copy()) for k, v in jax_to_torch_state(mparams).items()}
    target = {k: torch.from_numpy(v) for k, v in jax_to_torch_state(sparams).items()}
    got = transfer_mae_encoder(mae_sd, target, new_pos_embed_len=64)
    assert sorted(got) == sorted(want) == sorted(target)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert torch.equal(got["blocks.1.mlp.fc2.weight"], mae_sd["blocks.1.mlp.fc2.weight"])
    np.testing.assert_array_equal(got["pos_embed"].numpy(),
                                  interpolate_pos_embed_1d(mae_sd["pos_embed"].numpy(), 64))
    for k in ("neck.0.weight", "mask_header.0.weight", "adaptive_pos_dep_emb.0.weight"):
        assert torch.equal(got[k], target[k])


@pytest.mark.parametrize("name", ["sap", "sap_bf16"])
def test_cli_trains_sap_synthetic(tmp_path, monkeypatch, name):
    """`python -m ucf_vit_tpu_torch.train configs/basic_ct/<name>/base_config.yaml
    --single-device --synthetic --max-steps 2 --device cpu` on the config shrunk;
    without `--device cpu` and with no CUDA it raises."""
    raw = _sap_raw(name, checkpoint_path=str(tmp_path / "ck"))
    raw["parallelism"] = {"fsdp_size": 1, "simple_ddp_size": 8, "tensor_par_size": 1,
                          "seq_par_size": 1}
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = main([str(path), "--single-device", "--synthetic", "--max-steps", "2", "--device",
                "cpu"])
    model = out["state"].model
    assert isinstance(model, SAP) and model.dtype == (torch.bfloat16 if name == "sap_bf16"
                                                      else None)
    assert len(out["loss_list"]) == 1 and np.isfinite(out["loss_list"][0])
    assert os.path.isfile(tmp_path / "ck" / "multi_last_even.ckpt")
    assert ckpt.restore_checkpoint(str(tmp_path / "ck"), "")["head_meta"] == [2, 0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(path), "--single-device", "--synthetic", "--max-steps", "2"])


def test_cli_trains_sap_from_labelled_nifti_warm_started_from_an_mae(tmp_path, capsys):
    """`trainer.pretrained_mae_checkpoint` into SAP: the encoder equals the MAE's, the
    neck and head keep their init; then the shrunk basic_ct/sap trains from labelled
    NIfTI volumes through the CLI, in line and with a pool of 2, and saves."""
    mparams, _, raw = _mae_for_sap()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jax_to_torch_state(mparams).items()}
    mae_dir = tmp_path / "mae"
    os.makedirs(mae_dir)
    torch.save({"epoch": 3, "model_state_dict": sd, "loss_list": [], "head_meta": [2, 3]},
               str(mae_dir / "mae_odd.ckpt"))
    raw["trainer"].update(pretrained_mae_checkpoint=str(mae_dir),
                          checkpoint_path=str(tmp_path / "ck"))
    raw["data"].update(dict_root_dirs={"ct1": _labelled_volumes(tmp_path / "ct", 2, 32)},
                       num_workers=1)
    cfg = Config(raw=raw, task="sap")
    state, _ = init_train(cfg, "cpu")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    transfer_pretrained_mae(cfg, state.model, str(mae_dir))
    got = state.model.state_dict()
    assert torch.equal(got["blocks.1.attn.qkv.weight"], sd["blocks.1.attn.qkv.weight"])
    assert torch.equal(got["token_embeds.proj.weight"], sd["token_embeds.proj.weight"])
    for k in ("neck.0.weight", "mask_header.0.weight", "mask_header.0.bias"):
        assert torch.equal(got[k], init[k])
    for workers in (1, 3):
        raw["data"]["num_workers"] = workers
        path = tmp_path / f"sap_{workers}.yaml"
        path.write_text(yaml.safe_dump(raw))
        out = main([str(path), "--single-device", "--max-steps", "2", "--device", "cpu"])
        assert "initialized encoder from MAE checkpoint" in capsys.readouterr().out
        assert len(out["loss_list"]) == 1 and np.isfinite(out["loss_list"][0])
    assert os.path.isfile(tmp_path / "ck" / "multi_last_even.ckpt")


# ---------------------------------------------------------------- varemb in training
#
# imagenet/classification with `use_varemb` (three variables merged by the variable
# attention over the quadtree's tokens) shrunk: five f32 steps within LOSS_TOL of the
# JAX trainer's step; a single-channel run whose batches alternate variables hands
# each batch's var_ids to its step, as the JAX trainer keys its step by them.

VAREMB_STEPS = 5


def _varemb_raw(**data):
    raw = _adaptive_raw("imagenet/classification")
    raw["model"]["net"]["init_args"].update(use_varemb=True, num_heads=4)
    raw["data"].update(data)
    return raw


def test_varemb_train_steps_match_jax():
    raw = _varemb_raw()
    cfg = Config(raw=raw, task="classification")
    batches = _adaptive_batches(cfg, VAREMB_STEPS)
    jmod, jloss = jax_build_classification(JConfig(raw=raw, task="classification"))
    var_ids = jmod.get_var_ids(("red", "green", "blue"))
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = meta.unbox(jmod.init(jax.random.key(0), b0["seq"], var_ids,
                                  jax_seq_ps(b0))["params"])
    params = jax.tree.map(jnp.asarray, params)
    assert "var_agg" in params and "token_embed_2" in params
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(lambda p, b, r: jloss(p, b, r, var_ids=var_ids), tx,
                                donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task="classification")
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    assert model.get_var_ids(("red", "green", "blue")) == var_ids
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(task_loss(cfg), opt)
    losses = [step(state, to_device(b, torch.device("cpu")), var_ids)[1].item()
              for b in batches]
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)


def test_trainer_hands_alternating_variables_their_var_ids(monkeypatch):
    """Single-channel batches whose `variables` alternate (as two datasets of other
    variables give them): each step and each validation batch gets the var_ids the
    JAX model's `get_var_ids` gives for its batch, and the two variables' embeds
    both train."""
    from ucf_vit_tpu_torch import train as port_train

    raw = _varemb_raw(single_channel=True, num_channels_used={"d": 1})
    raw["trainer"].update(val_every=1, val_batches=2)
    cfg = Config(raw=raw, task="classification")
    jmod, _ = jax_build_classification(JConfig(raw=raw, task="classification"))
    order = [("green",), ("red",), ("blue",), ("green",)]

    def alternating(cfg, global_batch, seed=0):
        for i, b in enumerate(synthetic_batches(cfg, global_batch, seed)):
            b["variables"] = order[i % len(order)]
            yield b

    seen = []
    loss_of = port_train.task_loss

    def spying(cfg):
        inner = loss_of(cfg)

        def loss_fn(model, batch, var_ids=None):
            seen.append(var_ids)
            return inner(model, batch, var_ids=var_ids)

        return loss_fn

    monkeypatch.setattr(port_train, "synthetic_batches", alternating)
    monkeypatch.setattr(port_train, "task_loss", spying)
    out = train(cfg, max_steps=4, synthetic=True, device="cpu")
    want = [jmod.get_var_ids(v) for v in order]
    assert seen == want + want[:2]  # four steps, then the two validation batches
    init = init_train(cfg, "cpu")[0].model
    trained = out["state"].model
    assert all(not torch.equal(trained.token_embeds[i][1].weight, init.token_embeds[i][1].weight)
               for i in range(3))


# ================================================================ moved from test_torch_train.py
# Its trainer-parity section, moved whole (names, bodies and tolerances unchanged) to
# spread the tier-1 run's files over its workers.

import copy
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import yaml

from ucf_vit_tpu.config import Config as JConfig
from ucf_vit_tpu.train import train as jax_train
from ucf_vit_tpu_torch import checkpoint as ckpt
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.train import build_dataloader
from ucf_vit_tpu_torch.train import init_train
from ucf_vit_tpu_torch.train import synthetic_batches
from ucf_vit_tpu_torch.train import train
from test_torch_flash import DIFF_KW, DIFF_T, _adaptive_raw  # its DiffusionVIT and adaptive sections
from test_torch_train import (  # shared with that file
    LOSS_TOL,
    REPO,
    _assert_batches_equal,
    _catsdogs_raw,
    _jax_init_as_torch_file,
    _jpegs,
    _mae_raw,
    _metrics_losses,
    _raw,
    _resume_raw,
    _volumes,
)

# ================================================================ trainer parity
#
# Validation, preemption with mid-epoch resume, TensorBoard and profile_dir
# (`ucf_vit_tpu/train.py:95-200,360-420,550-990`). Validation losses against the JAX
# trainer's within LOSS_TOL: the port warm-started from the JAX trainer's own init,
# attention EINSUM on both, the same synthetic streams or JPEG files. A run preempted
# mid-epoch (or on an epoch's last step) and resumed against an uninterrupted one: the
# per-step losses, the validation losses, the parameters, AdamW's moments and the
# generators bit for bit.

from ucf_vit_tpu.train import build_dataloader as jax_build_dataloader
from ucf_vit_tpu_torch.train import _Validation

CATSDOGS_VAL = [f"{k}.{i}.jpg" for i, k in enumerate(["cat", "dog"] * 5)]


def _val_raw(tmp_path, source):
    """The tiny catsdogs ViT with validation every epoch over 3 batches of 2: from 10
    JPEGs (training on the first 6 of the split, 3 batches an epoch; validating on the
    other 4, 2 batches a pass, so a pass wraps into the next reshuffle), or from the
    synthetic streams (3 steps an epoch)."""
    if source == "catsdogs":
        raw = _catsdogs_raw(_jpegs(tmp_path / "cd", CATSDOGS_VAL))
        raw["data"].update(dict_end_idx={"catsdogs": 0.6}, val_dict_start_idx={"catsdogs": 0.6},
                           val_dict_end_idx={"catsdogs": 1.0})
    else:
        raw = _catsdogs_raw(str(tmp_path / "none"))
        raw["load_balancing"]["batches_per_rank_epoch"] = {"synthetic": 3}
    raw["trainer"].update(val_every=1, val_batches=3, max_epochs=2)
    return raw


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("source", ["synthetic", "catsdogs"])
def test_validation_matches_jax(tmp_path, source):
    """Two epochs, each followed by validation, through both trainers: the val_loss
    and val_accuracy records within LOSS_TOL of the JAX trainer's, 3 batches a pass,
    the train losses beside them."""
    raw = _val_raw(tmp_path, source)
    synthetic = source == "synthetic"
    raw["trainer"]["metrics_path"] = str(tmp_path / "jax.jsonl")
    jax_train(JConfig(raw=raw, task="classification"), synthetic=synthetic)
    init = tmp_path / "init.ckpt"
    _jax_init_as_torch_file(raw, str(init))
    raw["trainer"].update(metrics_path=str(tmp_path / "port.jsonl"), init_params_from=str(init))
    train(Config(raw=raw, task="classification"), synthetic=synthetic, device="cpu")
    got, want = _records(tmp_path / "port.jsonl"), _records(tmp_path / "jax.jsonl")
    vals = [[r for r in recs if "val_loss" in r] for recs in (got, want)]
    assert len(vals[0]) == len(vals[1]) == 2
    for g, w in zip(*vals):
        assert g["epoch"] == w["epoch"] and g["val_batches"] == w["val_batches"] == 3
        np.testing.assert_allclose([g["val_loss"], g["val_accuracy"]],
                                   [w["val_loss"], w["val_accuracy"]], atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(_metrics_losses(tmp_path / "port.jsonl"),
                               _metrics_losses(tmp_path / "jax.jsonl"), atol=LOSS_TOL, rtol=0)


def test_val_split_matches_jax_and_needs_its_range(tmp_path):
    """`build_dataloader(..., val_split=True)`: the synthetic held-out stream (seed
    12345) and the catsdogs held-out files batch for batch as the JAX package's; from
    files without `data.val_dict_*` the JAX assertion."""
    raw = _val_raw(tmp_path, "catsdogs")
    cfg, jcfg = Config(raw=raw, task="classification"), JConfig(raw=raw, task="classification")
    for synthetic in (True, False):
        dm, synth, _ = build_dataloader(cfg, 2, synthetic, val_split=True)
        jdm, jsynth, _ = jax_build_dataloader(jcfg, 2, synthetic, val_split=True)
        if synthetic:
            got, want = list(itertools.islice(synth, 2)), list(itertools.islice(jsynth, 2))
            assert not np.array_equal(got[0]["x"], next(synthetic_batches(cfg, 2))["x"])
        else:
            got = list(itertools.islice(dm.train_dataloader(loop=True), 3))
            want = list(itertools.islice(jdm.train_dataloader(loop=True), 3))
        _assert_batches_equal(got, want)
    del raw["data"]["val_dict_end_idx"]
    for build in (build_dataloader, jax_build_dataloader):
        with pytest.raises(AssertionError, match="val_dict_start_idx / val_dict_end_idx"):
            build((Config if build is build_dataloader else JConfig)(
                raw=raw, task="classification"), 2, False, val_split=True)


@pytest.mark.parametrize("task", ["classification", "mae"])
def test_validation_runs_in_eval_mode_on_its_own_generators(task):
    """A validation pass is deterministic where the task draws nothing in eval mode
    (a ViT with dropout 0.3 and DropPath 0.2: two seeds, one loss), draws MAE's mask
    from its own seed (two seeds, two losses), and leaves the trainer's generators,
    and the training mode, as it found them."""
    if task == "classification":
        raw = _raw()
        raw["model"]["net"]["init_args"].update(drop_rate=0.3, drop_path=0.2)
    else:
        raw = _mae_raw()
    cfg = Config(raw=raw, task=task)
    state, _ = init_train(cfg, "cpu")
    model = state.model.train()
    before = (model.generator.get_state(), model.host_generator.get_state())
    gens = (model.generator, model.host_generator)
    losses = [_Validation(cfg, 2, True, torch.device("cpu")).run(model, seed)
              for seed in (2, 2, 3)]
    assert all(n == 8 for _, _, n in losses)
    assert losses[0] == losses[1]
    assert (losses[0][0] == losses[2][0]) == (task == "classification")
    assert model.training and (model.generator, model.host_generator) == gens
    assert torch.equal(before[0], model.generator.get_state())
    assert torch.equal(before[1], model.host_generator.get_state())


def _midepoch_raw(tmp_path, kind):
    """3 steps an epoch from files: the catsdogs ViT of `_resume_raw` (dropout,
    DropPath, EMA, loss scaling: 6 JPEGs), the NIfTI MAE of `_resume_raw` on 3 volumes,
    or a 3-D DiffusionVIT on NIfTI volumes with validation every epoch (3 volumes to
    train on, 1 held out)."""
    if kind == "catsdogs":
        return _resume_raw(tmp_path, "vit")
    if kind == "mae":
        raw, task = _resume_raw(tmp_path, "mae")
        _volumes(tmp_path / "ct3", 3, (32, 16, 16))
        raw["data"]["dict_root_dirs"] = {"ct": str(tmp_path / "ct3")}
        return raw, task
    if kind == "adaptive_mae":  # basic_ct/mae shrunk: 2-D slices patchified in a pool
        raw = _adaptive_raw("basic_ct/mae")
        raw["trainer"].update(attn_impl="FLASH", seed=1)
        raw["data"].update(dict_root_dirs={"ct1": _volumes(tmp_path / "ct2d", 3, (32, 32, 2))},
                           batch_size=2, num_workers=2)
        raw["load_balancing"] = {"auto_load_balancing": True}
        return raw, "mae"
    root = _volumes(tmp_path / "ct4", 4, (32, 16, 16))
    ia = {"default_vars": ["ct"], "tile_size": [16, 16, 16], "twoD": False, "patch_size": 4,
          "adaptive_patching": False, "num_time_steps": DIFF_T,
          **{k: v for k, v in DIFF_KW.items() if k != "time_steps"}}
    raw = {"trainer": {"task": "diffusion", "attn_impl": "FLASH", "seed": 2, "val_every": 1,
                       "val_batches": 2},
           "parallelism": {},
           "model": {"lr": 1e-3, "warmup_steps": 1, "max_steps": 20, "use_grad_scaler": True,
                     "net": {"init_args": ia}},
           "data": {"dataset": "basic_ct", "dict_root_dirs": {"ct": root},
                    "dict_start_idx": {"ct": 0}, "dict_end_idx": {"ct": 0.75},
                    "val_dict_start_idx": {"ct": 0.75}, "val_dict_end_idx": {"ct": 1.0},
                    "dict_buffer_sizes": {"ct": 3}, "num_channels_used": {"ct": 1},
                    "dict_in_variables": {"ct": ["ct"]}, "batch_size": 2,
                    "single_channel": True, "num_workers": 2, "tile_overlap": 0.0,
                    "use_all_data": False},
           "load_balancing": {"auto_load_balancing": True}}
    return raw, "diffusion"


@pytest.mark.parametrize("kind,drill", [("catsdogs", 2), ("catsdogs", 3), ("mae", 2),
                                        ("mae", 3), ("diffusion", 2), ("adaptive_mae", 2)])
def test_midepoch_resume_equals_uninterrupted_bit_for_bit(tmp_path, capsys, kind, drill):
    """Two epochs of 3 steps in one run against a run preempted by the drill
    (`preempt_after_steps`) after step 2 (mid-epoch) or 3 (the epoch's last step) and
    then resumed (the adaptive MAE's loader patchifies in a spawn pool) (`tests/test_midepoch_resume.py:209-285`): the (epoch, it) records,
    every per-step loss and validation loss, the parameters, AdamW's moments and the
    generators equal bit for bit; the preemption checkpoint holds the interrupted
    epoch's position in the interrupted epoch's slot."""
    raw, task = _midepoch_raw(tmp_path, kind)

    def run(name, **trainer):
        r = copy.deepcopy(raw)
        r["trainer"].update(max_epochs=2, checkpoint_path=str(tmp_path / f"ck_{name}"),
                            checkpoint_filename="last",
                            checkpoint_filename_for_loading="last_latest",
                            metrics_path=str(tmp_path / f"{name}.jsonl"), **trainer)
        return train(Config(raw=r, task=task), device="cpu")

    whole = run("whole")
    part = run("part", preempt_after_steps=drill)
    mid = drill < 3
    assert f"preempted in epoch 0 after {drill} its: saved" in capsys.readouterr().out
    assert len(part["loss_list"]) == (0 if mid else 1)
    payload = ckpt.restore_checkpoint(str(tmp_path / "ck_part"), "last_latest")
    assert sorted(os.listdir(tmp_path / "ck_part")) == ["last_even.ckpt"]
    assert (payload["epoch"], payload["data_it"], payload["total_steps"],
            payload["num_procs"]) == (0, drill if mid else 0, drill, 1)
    resumed = run("part", resume_from_checkpoint=True)
    out = capsys.readouterr().out
    assert ("resumed mid-epoch: epoch 0, fast-forwarding 2 batches" if mid
            else "resumed from epoch 0") in out

    a, b = _records(tmp_path / "whole.jsonl"), _records(tmp_path / "part.jsonl")
    steps = [(r["epoch"], r["it"]) for r in a if "loss" in r]
    assert steps == [(e, i) for e in (0, 1) for i in (1, 2, 3)]
    assert [(r["epoch"], r["it"]) for r in b if "loss" in r] == steps
    assert [r["loss"] for r in b if "loss" in r] == [r["loss"] for r in a if "loss" in r]
    vals = [[(r["epoch"], r["val_loss"]) for r in recs if "val_loss" in r] for recs in (a, b)]
    assert vals[0] == vals[1] and len(vals[0]) == (2 if kind == "diffusion" else 0)
    starts = [r for r in b if r.get("run_start")]
    assert [(r["resume_epoch"], r["resume_step"], r["resume_it"]) for r in starts] == [
        (0, 0, 0), (0 if mid else 1, drill, drill if mid else 0)]
    if not mid:  # the completed epoch's loss, as the uninterrupted run's
        assert resumed["loss_list"] == whole["loss_list"]
    sa, sb = whole["state"], resumed["state"]
    for (n, p), (m, q) in zip(sa.model.state_dict().items(), sb.model.state_dict().items()):
        assert n == m and torch.equal(p, q), n
    oa, ob = sa.optimizer.adamw.state_dict()["state"], sb.optimizer.adamw.state_dict()["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    assert sa.optimizer.count == sb.optimizer.count == 6 and sa.loss_scale == sb.loss_scale
    assert torch.equal(sa.model.generator.get_state(), sb.model.generator.get_state())
    assert torch.equal(sa.model.host_generator.get_state(), sb.model.host_generator.get_state())


def _sigterm_yaml(tmp_path, **trainer):
    """The tiny synthetic classifier with epochs long enough that a signal lands in
    epoch 0, a checkpoint directory and a metrics file."""
    raw = _raw()
    raw["trainer"].update(checkpoint_path=str(tmp_path / "ck"), checkpoint_filename="last",
                          checkpoint_filename_for_loading="last_latest",
                          metrics_path=str(tmp_path / "m.jsonl"), max_epochs=1, **trainer)
    raw["load_balancing"] = {"batches_per_rank_epoch": {"synthetic": 100000}}
    path = tmp_path / "sigterm.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path), raw


def test_sigterm_checkpoints_exits_and_resumes_in_place(tmp_path):
    """SIGTERM to the trainer's CLI (a subprocess on the CPU) after its third logged
    step: exit code 0, the `preempted in epoch 0` line, a checkpoint at the step the
    signal stopped it (`data_it`); a run resumed from it continues that epoch at the
    next step, its `run_start` record carrying the position. The JAX counterpart
    (`tests/test_trainer.py:110-158`) sends its signal 2 s after the first step and
    asserts epoch 0, while its epochs of 100 steps take well under a second here: it
    checkpoints in a later epoch and fails. This one signals on a step's line, in an
    epoch of 100,000 steps, with deadlines of its own."""
    import queue
    import signal
    import threading
    import time as _time

    cfg, raw = _sigterm_yaml(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ucf_vit_tpu_torch.train", cfg, "--synthetic", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
                              daemon=True)
    reader.start()
    seen, deadline = [], _time.monotonic() + 240
    try:
        while True:
            line = lines.get(timeout=max(deadline - _time.monotonic(), 0.01))
            if line is None:
                pytest.fail("the trainer exited before its third step:\n" + "".join(seen))
            seen.append(line)
            if line.startswith("epoch 0 it 3 "):
                break
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    except (queue.Empty, subprocess.TimeoutExpired):
        pytest.fail("no third step, or no exit after SIGTERM, within the deadline:\n"
                    + "".join(seen))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    while (line := lines.get_nowait() if not lines.empty() else None) is not None:
        seen.append(line)
    text = "".join(seen)
    assert proc.returncode == 0, text[-2000:]
    stopped = re.search(r"preempted in epoch 0 after (\d+) its: saved (\S+)", text)
    assert stopped, text[-2000:]
    n = int(stopped.group(1))
    assert n >= 3 and stopped.group(2).endswith("last_even.ckpt")
    payload = ckpt.restore_checkpoint(str(tmp_path / "ck"), "last_latest")
    assert (payload["epoch"], payload["data_it"], payload["total_steps"]) == (0, n, n)

    raw["trainer"]["resume_from_checkpoint"] = True
    out = train(Config(raw=raw, task="classification"), synthetic=True, max_steps=n + 2,
                device="cpu")
    assert out["state"].optimizer.count == n + 2
    recs = _records(tmp_path / "m.jsonl")
    start = max(i for i, r in enumerate(recs) if r.get("run_start"))
    assert (recs[start]["resume_epoch"], recs[start]["resume_it"],
            recs[start]["resume_step"]) == (0, n, n)
    assert [(r["epoch"], r["it"], r["step"]) for r in recs[start + 1:]] == [
        (0, n + 1, n + 1), (0, n + 2, n + 2)]


def test_tensorboard_dir_writes_the_scalars(tmp_path):
    """`trainer.tensorboard_dir`: event files holding the train and val scalars of
    `ucf_vit_tpu/train.py:720-745,972-976`, beside the JSONL."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    raw = _raw()
    raw["trainer"].update(tensorboard_dir=str(tmp_path / "tb"), val_every=1, val_batches=1)
    raw["load_balancing"] = {"batches_per_rank_epoch": {"synthetic": 2}}
    train(Config(raw=raw, task="classification"), synthetic=True, device="cpu")
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert tags == {"train/loss", "train/ms_per_it", "train/samples_per_s", "train/accuracy",
                    "val/loss", "val/accuracy"}
    assert [e.step for e in acc.Scalars("train/loss")] == [1, 2]
    assert [e.step for e in acc.Scalars("val/loss")] == [2]


def test_tensorboard_dir_names_why_it_is_ignored(tmp_path, capsys):
    """Neither writer opens on a path under a file: training goes on, and the line
    names both writers' real errors."""
    (tmp_path / "file").write_text("")
    raw = _raw()
    raw["trainer"]["tensorboard_dir"] = str(tmp_path / "file" / "tb")
    out = train(Config(raw=raw, task="classification"), synthetic=True, max_steps=1,
                device="cpu")
    assert out["state"].optimizer.count == 1
    line = next(x for x in capsys.readouterr().out.splitlines()
                if x.startswith("tensorboard_dir ignored ("))
    assert "tensorboardX: " in line and "torch.utils.tensorboard: " in line


def test_profile_dir_writes_a_trace_of_steps_11_to_15(tmp_path, capsys):
    """`trainer.profile_dir`: a Chrome trace file of the profiler's CPU activity over
    steps 11-15 (`ucf_vit_tpu/train.py:853-879`), the train step's ops in it."""
    raw = _raw()
    raw["trainer"]["profile_dir"] = str(tmp_path / "prof")
    train(Config(raw=raw, task="classification"), synthetic=True, max_steps=16, device="cpu")
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    assert f"profile of steps 11-15 written to {tmp_path / 'prof' / files[0]}" in (
        capsys.readouterr().out)
    trace = json.load(open(tmp_path / "prof" / files[0]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert {"aten::addmm", "aten::softmax"} & names and any("backward" in n.lower()
                                                             for n in names)


# ================================================================ MoE and expert parallelism
#
# The port's `models/moe.py` against the JAX package's on seeded numpy inputs and
# `load_jax_params` weights, on the CPU: `expert_capacity` on a grid; the four
# properties of tests/test_moe.py with their tolerances; `MoeMlp`'s output, aux loss and
# gradients against `jax.grad` (f32, and the bf16 policy within 1e-2 of the largest
# entry); the MoE ViT (moe_every 2, and 1 under scan_layers) against flax; the five
# task losses with MoE; five train steps of imagenet/classification_moe shrunk. Then, in
# a fixture of its own, the sharded runs on gloo (see the comment there).

from ucf_vit_tpu.models import VIT as JVIT
from ucf_vit_tpu.models.blocks import Mlp as JMlp
from ucf_vit_tpu.models.moe import MoeMlp as JMoeMlp
from ucf_vit_tpu.models.moe import collect_moe_aux as jax_collect_moe_aux
from ucf_vit_tpu.models.moe import expert_capacity as jax_expert_capacity
from ucf_vit_tpu.tools.convert_checkpoint import export_torch_state
from ucf_vit_tpu_torch import tasks as port_tasks
from ucf_vit_tpu_torch.models import VIT
from ucf_vit_tpu_torch.models.blocks import Mlp
from ucf_vit_tpu_torch.models.moe import MoeMlp, expert_capacity, top_k_lower_first

MOE_F32_TOL = 1e-6  # output and aux, f32: the same products summed in another order
MOE_GRAD_TOL = 1e-5  # gradients, f32, times each one's largest entry
MOE_BF16_TOL = 1e-2  # bf16 policy, times each tensor's largest entry
MOE_LOGITS_TOL = 1e-5
MOE_BF16_LOSS_TOL = 5e-3  # per-step loss, bf16


def _moe_x(b=2, n=16, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(b, n, d)).astype(np.float32)


def _jax_moe(x, seed=0, **kw):
    """The JAX MoeMlp of `kw` and its params initialised on `x`."""
    jm = JMoeMlp(**kw)
    return jm, meta.unbox(jm.init(jax.random.key(seed), jnp.asarray(x))["params"])


def _port_moe(params, dtype=None, **kw):
    """The port's MoeMlp of the same `kw` (JAX keyword names) on `params`."""
    m = MoeMlp(kw["dim"], kw["hidden_features"], kw["num_experts"], top_k=kw.get("top_k", 2),
               capacity_factor=kw.get("capacity_factor", 1.25), dtype=dtype)
    return load_jax_params(m, jax.device_get(params))


def test_expert_capacity_matches_jax():
    grid = itertools.product([1, 16, 17, 197, 257], [1, 2, 4, 8, 64], [1, 2, 3],
                             [0.5, 1.0, 1.25, 2.0, 8.0])
    got = [(expert_capacity(n, e, k, cf), jax_expert_capacity(n, e, k, cf))
           for n, e, k, cf in grid]
    assert all(a == b for a, b in got)
    assert expert_capacity(197, 8, 2, 1.25) == 62  # classification_moe's 197 tokens


def test_top_k_breaks_ties_to_the_lower_expert_as_lax_top_k():
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 3, size=(4, 9, 8)).astype(np.float32) / 4  # many ties
    for k in (1, 2, 3, 8):
        v, i = top_k_lower_first(torch.from_numpy(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _prop_single_expert():
    """E = 1, k = 1, capacity N: the dense Mlp (tests/test_moe.py:36-56)."""
    d, h = 8, 16
    x = _moe_x(d=d)
    dense = JMlp(hidden_features=h, out_features=d, gelu_approx=True)
    pd = dense.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(dense.apply(pd, jnp.asarray(x)))
    k = meta.unbox(pd)["params"]
    params = {"router_kernel": np.zeros((d, 1), np.float32), "wi": k["fc1"]["kernel"][None],
              "bi": k["fc1"]["bias"][None], "wo": k["fc2"]["kernel"][None],
              "bo": k["fc2"]["bias"][None]}
    m = _port_moe(params, dim=d, hidden_features=h, num_experts=1, top_k=1, capacity_factor=1.0)
    port_dense = load_jax_params(Mlp(d, h, d), jax.device_get(k))
    x_t = torch.from_numpy(x)
    np.testing.assert_allclose(m(x_t).detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m(x_t).detach().numpy(), port_dense(x_t).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def _prop_top2():
    """Capacity >= N: the routed output equals the per-token dense sum (`:59-89`), and the
    JAX module's output."""
    d, h, e = 8, 16, 4
    x = _moe_x(b=2, n=8, d=d, seed=3)
    kw = dict(dim=d, hidden_features=h, num_experts=e, top_k=2, capacity_factor=float(e))
    jm, p = _jax_moe(x, **kw)
    out = _port_moe(p, **kw)(torch.from_numpy(x)).detach().numpy()
    logits = np.einsum("bnd,de->bne", x, np.asarray(p["router_kernel"]))
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gates, idx = jax.lax.top_k(probs, 2)
    gates, idx = np.asarray(gates / gates.sum(-1, keepdims=True)), np.asarray(idx)

    def expert(eid, tok):
        hdn = tok @ np.asarray(p["wi"])[eid] + np.asarray(p["bi"])[eid]
        hdn = np.asarray(jax.nn.gelu(jnp.asarray(hdn), approximate=True))
        return hdn @ np.asarray(p["wo"])[eid] + np.asarray(p["bo"])[eid]

    want = np.zeros_like(out)
    for b in range(x.shape[0]):
        for n in range(x.shape[1]):
            for kk in range(2):
                want[b, n] += gates[b, n, kk] * expert(idx[b, n, kk], x[b, n])
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
    jout, _ = jm.apply({"params": p}, jnp.asarray(x), mutable="moe")
    np.testing.assert_allclose(out, np.asarray(jout), rtol=0, atol=MOE_F32_TOL)


def _prop_overflow():
    """Every token on expert 0 with C < N: the first C tokens get output, the rest zero
    (`:92-108`)."""
    d, h, e, n = 8, 16, 2, 8
    x = _moe_x(b=1, n=n, d=d, seed=5)
    kw = dict(dim=d, hidden_features=h, num_experts=e, top_k=1, capacity_factor=0.5)
    _, p = _jax_moe(x, **kw)
    p["router_kernel"] = np.zeros((d, e), np.float32)
    c = expert_capacity(n, e, 1, 0.5)
    assert c == 2
    out = _port_moe(p, **kw)(torch.from_numpy(x)).detach().numpy()
    assert np.abs(out[0, :c]).max() > 0
    np.testing.assert_allclose(out[0, c:], 0.0, atol=1e-7)


def _prop_zero_router():
    """Equal logits: expert 0 wins every tie, so the Switch aux is E * (1 * 1/E) = 1
    (`:111-121`)."""
    d = 8
    x = _moe_x(d=d, seed=7)
    kw = dict(dim=d, hidden_features=16, num_experts=4, top_k=1)
    _, p = _jax_moe(x, **kw)
    p["router_kernel"] = np.zeros((d, 4), np.float32)
    m = _port_moe(p, **kw)
    m(torch.from_numpy(x))
    np.testing.assert_allclose(float(m.aux_loss), 1.0, rtol=1e-6)
    _, _, idx, _, _ = m.route(torch.from_numpy(x))
    assert (idx == 0).all()


@pytest.mark.parametrize("prop", ["single_expert_is_dense", "top2_dense_oracle",
                                  "overflow_drops_in_sequence_order", "zero_router_aux_one"])
def test_moe_properties_of_the_jax_tests(prop):
    {"single_expert_is_dense": _prop_single_expert, "top2_dense_oracle": _prop_top2,
     "overflow_drops_in_sequence_order": _prop_overflow,
     "zero_router_aux_one": _prop_zero_router}[prop]()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_output_aux_and_gradients_match_jax_grad(dtype):
    """`MoeMlp` (D 16, H 32, 4 experts, top-2, capacity 1.25 of 24 tokens: some drop) on
    the same params: the output and the aux loss against the JAX module's under the same
    policy, and the gradients of `sum(y * w) + 0.3 * aux` for the input and the five
    leaves against `jax.grad`'s. Under the bf16 policy the gradients are held to the JAX
    module's f32 ones: its own bf16 bias gradient `bo` sums 45 rows in bf16 and sits
    1.3e-2 of the largest entry from f32 (the port's 2.6e-3), so the two bf16 results
    are compared through the f32 they both approximate."""
    d, h, e = 16, 32, 4
    x = _moe_x(b=3, n=24, d=d, seed=11)
    w = np.random.default_rng(12).normal(size=x.shape).astype(np.float32)
    bf16 = dtype == "bfloat16"
    kw = dict(dim=d, hidden_features=h, num_experts=e, top_k=2, capacity_factor=1.25)

    def jax_run(jdt):
        jm = JMoeMlp(dtype=jdt, **kw)
        p = meta.unbox(jm.init(jax.random.key(0), jnp.asarray(x))["params"])

        def loss(params, xx):
            y, mut = jm.apply({"params": params}, xx, mutable="moe")
            aux = jax_collect_moe_aux(mut)
            return (y.astype(jnp.float32) * w).sum() + 0.3 * aux, (y, aux)

        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            p, jnp.asarray(x))
        return p, y, aux, grads

    p, jy, jaux, _ = jax_run(jnp.bfloat16 if bf16 else None)
    gp, gx = jax_run(None)[3]
    m = _port_moe(p, dtype=torch.bfloat16 if bf16 else None, **kw)
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt)
    ((y.float() * torch.from_numpy(w)).sum() + 0.3 * m.aux_loss).backward()
    assert y.dtype == torch.float32  # the input's, as the JAX module returns
    assert abs(m.aux_loss.item() - float(jaux)) <= MOE_F32_TOL  # the router is f32 in both
    jy = np.asarray(jy, np.float32)
    np.testing.assert_allclose(y.detach().float().numpy(), jy, rtol=0,
                               atol=MOE_BF16_TOL * np.abs(jy).max() if bf16 else MOE_F32_TOL)
    got = {"x": xt.grad, **{k: getattr(m, k).grad for k in ("router_kernel", "wi", "bi", "wo",
                                                            "bo")}}
    for k, v in {"x": gx, **gp}.items():
        v = np.asarray(v, np.float32)
        tol = (MOE_BF16_TOL if bf16 else MOE_GRAD_TOL) * np.abs(v).max()
        np.testing.assert_allclose(got[k].numpy(), v, atol=tol, rtol=0, err_msg=k)


MOE_VIT_KW = dict(img_size=(16, 16), patch_size=8, in_chans=3, num_classes=4, embed_dim=16,
                  depth=2, num_heads=2, moe_num_experts=4, moe_top_k=2)


@pytest.mark.parametrize("every,scan", [(2, False), (1, True)], ids=["every2", "scan_every1"])
def test_moe_vit_logits_aux_and_conversion_match_flax(every, scan):
    x = np.random.default_rng(0).normal(size=(3, 3, 16, 16)).astype(np.float32)
    jmod = JVIT(default_vars=("v",), attn_impl=JAttnImpl.EINSUM, moe_every=every,
                scan_layers=scan, **MOE_VIT_KW)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    jlogits, mut = jmod.apply({"params": params}, jnp.asarray(x), mutable="moe")
    ours = VIT(attn_impl="EINSUM", moe_every=every, scan_layers=scan, **MOE_VIT_KW)
    assert [b.is_moe for b in ours.blocks] == ([False, True] if every == 2 else [True, True])
    load_jax_params(ours, jax.device_get(params))
    theirs = export_torch_state(jax.device_get(params))
    assert set(ours.state_dict()) == set(theirs)
    for k, v in ours.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs[k]), err_msg=k)
    assert "blocks.1.moe_mlp.router_kernel" in theirs
    with torch.no_grad():
        logits = ours.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=MOE_LOGITS_TOL, rtol=0)
    assert abs(float(ours.moe_aux) - float(jax_collect_moe_aux(mut))) <= MOE_LOGITS_TOL


@pytest.mark.parametrize("every", [1, 2])
def test_moe_vit_under_remat_matches_jax_grad(every):
    """The MoE ViT under `remat` in training, each block's forward (the routing, the
    aux's side output) run again in the backward, against flax's `nn.remat` model on
    the same weights: the loss `sum(logits * w) + 0.1 * aux` within MOE_LOGITS_TOL and
    the gradient of every leaf, the routers' among them, within MOE_GRAD_TOL of each
    one's largest entry."""
    x = np.random.default_rng(1).normal(size=(3, 3, 16, 16)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(3, MOE_VIT_KW["num_classes"])).astype(np.float32)
    jmod = JVIT(default_vars=("v",), attn_impl=JAttnImpl.EINSUM, moe_every=every, remat=True,
                **MOE_VIT_KW)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(x))["params"])

    def jloss(p):
        logits, mut = jmod.apply({"params": p}, jnp.asarray(x), deterministic=False,
                                 mutable="moe")
        return (logits * w).sum() + 0.1 * jax_collect_moe_aux(mut)

    want, grads = jax.jit(jax.value_and_grad(jloss))(params)
    ours = VIT(attn_impl="EINSUM", moe_every=every, remat=True, **MOE_VIT_KW)
    load_jax_params(ours, jax.device_get(params)).train()
    moe = [b.moe_mlp for b in ours.blocks if b.is_moe]
    calls = []
    for m in moe:
        m.register_forward_pre_hook(lambda *_: calls.append(1))
    got = (ours(torch.from_numpy(x)) * torch.from_numpy(w)).sum() + 0.1 * ours.moe_aux
    got.backward()
    assert len(calls) == 2 * len(moe)  # each MoE layer began again in the backward
    assert abs(got.item() - float(want)) <= MOE_LOGITS_TOL
    theirs = export_torch_state(jax.device_get(grads))
    assert {n for n, _ in ours.named_parameters()} == set(theirs)
    for n, p in ours.named_parameters():
        v = np.asarray(theirs[n], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), v, atol=MOE_GRAD_TOL * np.abs(v).max(),
                                   rtol=0, err_msg=n)


def test_moe_under_scan_layers_needs_moe_every_1_as_jax():
    with pytest.raises(AssertionError, match="requires moe_every == 1") as ours:
        VIT(scan_layers=True, moe_every=2, **MOE_VIT_KW)
    jmod = JVIT(default_vars=("v",), scan_layers=True, moe_every=2, **MOE_VIT_KW)
    with pytest.raises(AssertionError) as theirs:
        jmod.init(jax.random.key(0), jnp.zeros((1, 3, 16, 16)))
    assert str(ours.value) == str(theirs.value)


from test_torch_dropout import (  # its sharded section's configs, batches and JAX runs
    _jax_init_fn,
    _jax_tx,
    _shard_batches,
    _shard_model_raw,
)
from ucf_vit_tpu.models.ddpm import ddpm_schedule as jax_ddpm_schedule
from ucf_vit_tpu.models.ddpm import q_sample as jax_q_sample
from ucf_vit_tpu.ops.patchify import patchify as jpatchify
from ucf_vit_tpu.ops.patchify import unpatchify as junpatchify
from ucf_vit_tpu.tasks import build_task as jax_build_task
from ucf_vit_tpu.utils import metrics as jax_metrics
from ucf_vit_tpu_torch.ops.patchify import patchify as port_patchify
from ucf_vit_tpu_torch.utils import metrics as port_metrics

MOE_ARGS = dict(moe_num_experts=4, moe_top_k=2, moe_every=1, moe_aux_weight=0.1)
MOE_TASK_LOSS_TOL = 1e-5


def _moe_raw(task, **par):
    """`_shard_model_raw(task)` (depth 2; UNETR 4) with every block MoE."""
    raw = _shard_model_raw(task, **par)
    raw["model"]["net"]["init_args"].update(MOE_ARGS)
    return raw


def _jax_moe_loss(task, jmod, jloss, raw):
    """The JAX task loss, with MAE's noise and diffusion's (t, e) from the batch (the
    task's own draws them), the MoE term as `_apply` adds it."""
    w = raw["model"]["net"]["init_args"]["moe_aux_weight"]
    if task == "mae":
        def mae_loss(params, batch, rng):
            (pred, mask), mut = jmod.apply({"params": params}, batch["x"], deterministic=False,
                                           mask_noise=batch["mask_noise"], mutable="moe",
                                           rngs={"dropout": rng})
            return jax_metrics.masked_mse(pred, jpatchify(batch["x"], 4, False), mask) + (
                w * jax_collect_moe_aux(mut)), {}
        return mae_loss
    if task == "diffusion":
        def diff_loss(params, batch, rng):
            x0 = batch["x"]
            xt = jax_q_sample(jax_ddpm_schedule(raw["model"]["net"]["init_args"]["num_time_steps"]),
                              x0, batch["t"], batch["e"])
            pred, mut = jmod.apply({"params": params}, xt, batch["t"], deterministic=True,
                                   mutable="moe")
            return jax_metrics.mse(junpatchify(pred, x0.shape, 4, True), batch["e"]) + (
                w * jax_collect_moe_aux(mut)), {}
        return diff_loss
    return lambda params, batch, rng: jloss(params, batch, rng, deterministic=True)


def _port_moe_loss(task, cfg):
    """The port's task loss; MAE's with the batch's noise (`tasks.with_moe_aux` adds the
    MoE term as the task loss does)."""
    if task != "mae":
        return port_tasks.task_loss(cfg)

    def mae_loss(model, batch):
        pred, mask = model(batch["x"], mask_noise=batch["mask_noise"])
        loss = port_metrics.masked_mse(pred, port_patchify(batch["x"], 4, False), mask)
        return port_tasks.with_moe_aux(cfg, model, loss, {})
    return mae_loss


@pytest.mark.parametrize("task", ["classification", "mae", "diffusion", "unetr", "sap"])
def test_moe_task_losses_match_jax(task):
    """Each task's loss of a model whose blocks are all MoE (4 experts, top-2) on the same
    weights and batch: the JAX task's loss plus its weighted aux, within 1e-5; the aux
    reported beside it."""
    raw = _moe_raw(task)
    cfg = Config(raw=raw, task=task)
    batch = _shard_batches(task, raw, 1)[0]
    jmod, jloss = jax_build_task(JConfig(raw=raw, task=task))
    params = meta.unbox(_jax_init_fn(task, jmod, batch, cfg.sqrt_len)()["params"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = _jax_moe_loss(task, jmod, jloss, raw)(params, jb, jax.random.key(0))
    model = load_jax_params(port_tasks.build_task(cfg), jax.device_get(params))
    assert sum(b.is_moe for b in model.blocks) == len(model.blocks)
    (model.train() if task == "mae" else model.eval())
    with torch.no_grad():
        got, aux = _port_moe_loss(task, cfg)(model, to_device(batch, torch.device("cpu")))
    assert abs(got.item() - float(want)) <= MOE_TASK_LOSS_TOL
    assert aux["moe_aux"].item() > 0.5 and model.moe_aux is not None


@pytest.mark.parametrize("dtype, tol", [("float32", LOSS_TOL), ("bfloat16", MOE_BF16_LOSS_TOL)])
def test_classification_moe_train_steps_match_jax(dtype, tol):
    """imagenet/classification_moe shrunk (adaptive, 16 quadtree tokens and the class
    token, width 32, depth 2: block 1 MoE with 8 experts, top-2, capacity 1.25), five
    steps from one JAX init; the port's attention FLASH: each step's loss within `tol`."""
    raw = _adaptive_raw("imagenet/classification_moe")
    raw["trainer"]["data_type"] = dtype
    jcfg, cfg = JConfig(raw=raw, task="classification"), Config(raw=raw, task="classification")
    batches = _adaptive_batches(cfg, 5)
    jmod, jloss = jax_build_classification(jcfg)
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = meta.unbox(jmod.init(jax.random.key(0), first["seq"], None,
                                  jax_seq_ps(first))["params"])
    params = jax.tree.map(jnp.asarray, params)
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(jloss, tx, donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))
    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task="classification")
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    assert [b.is_moe for b in model.blocks] == [False, True]
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(task_loss(cfg), opt)
    out = [step(state, to_device(b, torch.device("cpu"))) for b in batches]
    losses = [o[1].item() for o in out]
    np.testing.assert_allclose(losses, jax_losses, atol=tol, rtol=0)
    assert all(0.5 < o[2]["moe_aux"].item() < 8 for o in out)


# ---------------------------------------------------------------- expert parallelism
#
# ep > 1 on the CPU over gloo, in a fixture of its own that starts one group of 4 and
# one of 2 (`tests/_torch_sharded.py`): three train steps of the MoE classifier (every
# block MoE, 4 experts, top-2, the clip and two microbatches) on (ep 2), (ddp 2, ep 2),
# (ep 2, fsdp 2), (ep 2, tp 2), (ep 4), (ep 2, sp 2) and (ep 2) under remat against the
# JAX package's
# sharded step on the same mesh shape and weights (`tests/test_moe.py:150-205`), the
# gathered parameters against the port's one device and each rank's experts; the
# replica check on (ddp 2, ep 2); an ep-2 checkpoint resumed on one device, on ep 2 and
# on ddp 2 and converted by `to-jax`; a mid-epoch resume on ep 2 from catsdogs files;
# top-1 on an ep-2 eval mesh against one device and the JAX package's sharded
# `evaluate_classification`; a two-rank ep server's answers.

import _torch_sharded
from test_torch_dropout import (  # its sharded section's checks and configs
    EVAL_SERVE_TOL,
    LAYOUT_LOSS_TOL,
    SHARD_LOSS_TOL,
    _assert_params_match,
    _catsdogs_yaml,
    _free_port,
    _jax_loss,
    _step_losses,
)
from ucf_vit_tpu.parallel import make_mesh as jax_make_mesh
from ucf_vit_tpu.parallel.mesh import mesh_context as jax_mesh_context
from ucf_vit_tpu.parallel.mesh import shard_batch as jax_shard_batch
from ucf_vit_tpu.parallel.train_step import create_sharded_train_state
from ucf_vit_tpu.tools.convert_checkpoint import main as convert_main

EP_CASES = {  # name: (ddp, ep, fsdp, sp, tp)
    "ep2": (1, 2, 1, 1, 1),
    "ddp2_ep2": (2, 2, 1, 1, 1),
    "ep2_fsdp2": (1, 2, 2, 1, 1),
    "ep2_tp2": (1, 2, 1, 1, 2),
    "ep4": (1, 4, 1, 1, 1),
    "ep2_sp2": (1, 2, 1, 2, 1),
    "ep2_remat": (1, 2, 1, 1, 1),  # each block's forward, all-to-alls too, run again
}
EP_GLOBAL_BATCH = 8
EP_CLI_ITS = 3


def _ep_raw(shape, remat=False):
    """The MoE classifier (`_moe_raw`) on the mesh `shape` (ddp, ep, fsdp, sp, tp),
    `data.batch_size` a data rank's share of EP_GLOBAL_BATCH, each block under `remat`
    if asked (under fsdp it is by default). Under sp the tile is 24 (nine tokens and
    the class token: sp divides them, so the stack splits)."""
    ddp, ep, fsdp, sp, tp = shape
    raw = _moe_raw("classification")
    if remat:
        raw["trainer"]["remat"] = True
    raw["parallelism"] = {"simple_ddp_size": ddp, "expert_par_size": ep, "fsdp_size": fsdp,
                          "seq_par_size": sp, "tensor_par_size": tp}
    raw["data"]["batch_size"] = EP_GLOBAL_BATCH // (ddp * ep * fsdp)
    if sp > 1:
        raw["model"]["net"]["init_args"]["tile_size"] = [24, 24]
    return raw


def _jax_ep_steps(raw, shape):
    """The JAX package's steps of `raw` on the mesh `shape` (ddp, ep, fsdp, sp, tp):
    (its init as whole torch-layout weights, the per-step losses, the batches)."""
    ddp, ep, fsdp, sp, tp = shape
    batches = _shard_batches("classification", raw)
    jmod, jloss = jax_build_task(JConfig(raw=raw, task="classification"))
    mesh = jax_make_mesh(simple_ddp_size=ddp, fsdp_size=fsdp, seq_par_size=sp,
                         tensor_par_size=tp, expert_par_size=ep)
    init_fn = _jax_init_fn("classification", jmod, batches[0])
    tx = _jax_tx(raw, jax.eval_shape(init_fn)["params"])
    with jax_mesh_context(mesh):
        state, _ = create_sharded_train_state(init_fn, tx, mesh)
        init = jax_to_torch_state(jax.device_get(state.params))
        step = jax_make_train_step(_jax_loss("classification", jmod, jloss, raw), tx,
                                   donate=False, accum_steps=raw["trainer"]["accum_steps"])
        losses = []
        for b in batches:
            state, loss, _ = step(state, jax_shard_batch(mesh, {k: jnp.asarray(v)
                                                                for k, v in b.items()}),
                                  jax.random.key(0))
            losses.append(float(loss))
    return init, losses, batches


def _ep_cli_yaml(tmp, name, par, **trainer):
    """The MoE classifier through the CLI on `par`, synthetic, EP_CLI_ITS steps an
    epoch, with a loss scale, EMA and a save."""
    raw = _moe_raw("classification")
    raw["model"].update(use_grad_scaler=True)
    raw["trainer"] = {"task": "classification", "attn_impl": "EINSUM", "seed": 0,
                      "ema_decay": 0.99, "max_epochs": 1, "checkpoint_path": str(tmp / "ck"),
                      "checkpoint_filename": name, "metrics_path": str(tmp / f"{name}.jsonl"),
                      **trainer}
    raw["parallelism"] = par
    raw["data"]["batch_size"] = EP_GLOBAL_BATCH // int(np.prod(
        [par.get(k, 1) for k in ("simple_ddp_size", "expert_par_size", "fsdp_size")]))
    raw["load_balancing"] = {"batches_per_rank_epoch": {"d": EP_CLI_ITS}}
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _ep_catsdogs_yaml(tmp, name, **trainer):
    """`_catsdogs_yaml` (16 JPEGs, two epochs) with MoE blocks on (ep 2)."""
    path = _catsdogs_yaml(tmp, name, **trainer)
    raw = yaml.safe_load(open(path))
    raw["parallelism"] = {"expert_par_size": 2}
    raw["model"]["net"]["init_args"].update(MOE_ARGS)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _ep_eval_raw(par):
    raw = _moe_raw("classification")
    raw["data"].update(batch_size=4, num_classes=3)
    raw["parallelism"] = par
    return raw


def _ep_eval_checkpoint(tmp):
    """The MoE classifier's seeded init plus N(0, 0.05) noise (so that no logits tie),
    as a weights-only checkpoint file, and its `to-jax` conversion."""
    raw = _ep_eval_raw({})
    model = port_tasks.build_task(Config(raw=raw, task="classification"))
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    sd = {k: v + torch.from_numpy(0.05 * rng.normal(size=tuple(v.shape)).astype(np.float32))
          for k, v in model.state_dict().items()}
    path = tmp / "ep_eval.ckpt"
    torch.save({"epoch": 3, "model_state_dict": sd, "loss_list": []}, path)
    cfg_path = tmp / "ep_eval.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    assert convert_main(["to-jax", str(path), str(cfg_path), str(tmp / "ep_eval_jax"),
                         "--filename", "conv"]) == 0
    return str(path)


EP_HTTP_INPUTS = 6


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """Every expert-parallel case's JAX run, port run (on its group) and single-device
    run (here), and the checkpoint, resume, evaluation and serving runs."""
    from ucf_vit_tpu_torch.inference import evaluate_classification
    from ucf_vit_tpu_torch.serve import build_predictor

    tmp = tmp_path_factory.mktemp("ep")
    jobs, single = {4: [], 2: []}, {}
    for name, shape in EP_CASES.items():
        raw = _ep_raw(shape, remat=name.endswith("_remat"))
        init, jax_losses, batches = _jax_ep_steps(raw, shape)
        job = {"kind": "train", "name": name, "raw": raw, "batches": batches, "init": init}
        jobs[int(np.prod(shape))].append(job)
        one = copy.deepcopy(raw)
        one["parallelism"], one["data"]["batch_size"] = {}, EP_GLOBAL_BATCH
        single[name] = {**_torch_sharded.train_job({**job, "raw": one}),
                        "jax_losses": jax_losses}
    sync_raw = _ep_raw(EP_CASES["ddp2_ep2"])
    jobs[4] += [{"kind": "sync_check", "name": "ep_sync", "raw": sync_raw, "corrupt": 1,
                 "leaf": "blocks.0.moe_mlp.wi"}]
    # the CLI: an epoch on ep 2 with the sync check every step and a save; that epoch's
    # checkpoint resumed for one more on ep 2, ddp 2 and one device; mid-epoch on ep 2
    ep2, resume = {"expert_par_size": 2}, dict(resume_from_checkpoint=True, max_epochs=2,
                                               checkpoint_filename_for_loading="mp_even")
    jobs[2] += [
        {"kind": "cli", "name": "mp", "argv": [_ep_cli_yaml(tmp, "mp", ep2, sync_check_every=1),
                                               "--synthetic", "--device", "cpu"]},
        {"kind": "cli", "name": "mq_ep2", "argv": [
            _ep_cli_yaml(tmp, "mq_ep2", ep2, **resume), "--synthetic", "--device", "cpu"]},
        {"kind": "cli", "name": "mq_ddp2", "argv": [
            _ep_cli_yaml(tmp, "mq_ddp2", {"simple_ddp_size": 2}, **resume), "--synthetic",
            "--device", "cpu"]},
        {"kind": "cli", "name": "mu", "argv": [_ep_catsdogs_yaml(tmp, "mu"), "--device", "cpu"]},
        {"kind": "cli", "name": "mv", "argv": [
            _ep_catsdogs_yaml(tmp, "mv", preempt_after_steps=2), "--device", "cpu"]},
        {"kind": "cli", "name": "mw", "argv": [
            _ep_catsdogs_yaml(tmp, "mw", checkpoint_filename="mv", resume_from_checkpoint=True,
                              checkpoint_filename_for_loading="mv_latest"), "--device", "cpu"]},
    ]
    # evaluation and serving on an ep-2 eval mesh
    ck = _ep_eval_checkpoint(tmp)
    inputs = np.random.default_rng(9).normal(size=(EP_HTTP_INPUTS, 3, 32, 32)).astype(
        np.float32)
    http_path = tmp / "ep_http.yaml"
    http_path.write_text(yaml.safe_dump(_ep_eval_raw(ep2)))
    jobs[2] += [
        {"kind": "eval", "name": "ep_top1", "raw": _ep_eval_raw(ep2),
         "fn": "evaluate_classification", "args": (ck, True, 12)},
        {"kind": "serve", "name": "ep_http", "path": str(http_path), "port": _free_port(),
         "max_batch": 4, "inputs": inputs, "phases": [("lone", [0, 1]),
                                                       ("concurrent", [2, 3, 4, 5])]},
    ]
    out = {}
    for world in (4, 2):
        out.update(_torch_sharded.run_group(world, jobs[world], tmp))
    one = Config(raw=_ep_eval_raw({}), task="classification")
    single["ep_top1"] = evaluate_classification(one, ck, True, 12, device="cpu")
    run_batch = build_predictor(one, max_batch=4, device="cpu")[0]
    single["ep_http"] = np.stack([run_batch({"x": np.repeat(inputs[i:i + 1], 4, 0)}).numpy()[0]
                                  for i in range(EP_HTTP_INPUTS)])
    single["mq_one"] = main([_ep_cli_yaml(tmp, "mq_one", {}, **resume), "--synthetic",
                                   "--device", "cpu"])
    return out, single, tmp


@pytest.mark.parametrize("name", sorted(EP_CASES))
def test_expert_parallel_train_step_matches_jax_and_single_device(ep_runs, name):
    """Three steps on the case's mesh against the JAX package's sharded step on the
    same mesh shape (each step's loss within SHARD_LOSS_TOL) and the port's single
    device (the same; the gathered parameters within SHARD_PARAM_TOL of each leaf's
    largest entry); each rank holds E/ep experts of each expert leaf."""
    runs, single, _ = ep_runs
    got = runs[name]
    ddp, ep, fsdp, sp, tp = EP_CASES[name]
    np.testing.assert_allclose(got["losses"], single[name]["jax_losses"], atol=SHARD_LOSS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["losses"], single[name]["losses"], atol=SHARD_LOSS_TOL,
                               rtol=0)
    _assert_params_match(got["params"], single[name]["params"], name)
    experts = MOE_ARGS["moe_num_experts"]
    assert set(got["experts"]) == {f"blocks.{i}.moe_mlp.{leaf}" for i in range(2)
                                   for leaf in ("wi", "bi", "wo", "bo")}
    assert set(got["experts"].values()) == {experts // ep}
    if tp > 1:  # the experts' hidden dim split too
        assert "blocks.0.moe_mlp.wi" in got["sharded"]


def test_replica_check_compares_expert_leaves_within_an_ep_index(ep_runs):
    """On (ddp 2, ep 2) the check passes; with one rank's copy of an expert leaf
    changed it names that rank's ep index's group alone (ranks 1 and 3)."""
    runs, _, _ = ep_runs
    got = runs["ep_sync"]
    assert got["ok"] and got["redundancy"] == ("ddp", "ep")
    assert got["caught"] is not None and got["mismatches"] == [[1, 3]]


def test_ep_checkpoint_resumes_on_one_device_ep2_and_ddp2(ep_runs):
    """An epoch on ep 2 saved (the sync check passing every step) and resumed for one
    more on one device, on ep 2 and on ddp 2: the same losses within LAYOUT_LOSS_TOL;
    the file holds the experts whole."""
    runs, single, tmp = ep_runs
    assert runs["mp"]["step"] == EP_CLI_ITS
    recs = [json.loads(line) for line in open(tmp / "mp.jsonl")]
    assert all("OK" in r["sync_check"] for r in recs if "sync_check" in r)
    assert all("moe_aux" in r for r in recs if "loss" in r and "step" in r)
    sd = torch.load(tmp / "ck" / "mp_even.ckpt", weights_only=True)["model_state_dict"]
    assert sd["blocks.0.moe_mlp.wi"].shape[0] == MOE_ARGS["moe_num_experts"]
    want = _step_losses(tmp / "mq_ep2.jsonl")
    assert sorted(want) == [EP_CLI_ITS + i for i in (1, 2, 3)]
    for other in ("mq_one", "mq_ddp2"):
        got = _step_losses(tmp / f"{other}.jsonl")
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose([got[k] for k in sorted(got)], [want[k] for k in sorted(want)],
                                   atol=LAYOUT_LOSS_TOL, rtol=0, err_msg=other)


def test_ep_checkpoint_converts_with_to_jax_key_for_key(ep_runs, tmp_path):
    _, _, tmp = ep_runs
    src = tmp / "ck" / "mp_even.ckpt"
    assert convert_main(["to-jax", str(src), str(tmp / "mp.yaml"), str(tmp_path / "jax"),
                         "--filename", "conv"]) == 0
    from ucf_vit_tpu import checkpoint as jax_ckpt

    payload = jax_ckpt.restore_checkpoint(str(tmp_path / "jax"), "conv_latest")
    back = export_torch_state(payload["state"]["params"])
    sd = torch.load(src, weights_only=True)["model_state_dict"]
    assert set(back) == set(sd) and "blocks.1.moe_mlp.wo" in sd
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy(), err_msg=k)


def test_midepoch_resume_on_ep2_is_bit_for_bit(ep_runs):
    """The MoE classifier on (ep 2) from catsdogs files: preempted after step 2 and
    resumed in place, against the run that was not interrupted: every step's loss
    equal."""
    _, _, tmp = ep_runs
    full, resumed = _step_losses(tmp / "mu.jsonl"), _step_losses(tmp / "mw.jsonl")
    first = _step_losses(tmp / "mv.jsonl")
    assert sorted(first) == [1, 2] and len(full) == 8
    assert sorted(resumed) == list(range(3, 9))
    assert {**first, **resumed} == full


def test_top1_on_an_ep2_eval_mesh_matches_one_device_and_jax(ep_runs):
    """`evaluate_classification` of a checkpoint on the ep-2 eval mesh (every rank runs
    every forward) against one device's and the JAX package's on the `to-jax`
    conversion on the same mesh shape: the same top-1 over 12 synthetic samples."""
    from ucf_vit_tpu.inference import evaluate_classification as jax_evaluate_classification

    runs, single, tmp = ep_runs
    jraw = _ep_eval_raw({"expert_par_size": 2})
    jraw["trainer"]["checkpoint_filename_for_loading"] = "conv_latest"
    want = jax_evaluate_classification(JConfig(raw=jraw, task="classification"),
                                       str(tmp / "ep_eval_jax"), True, 12)
    assert runs["ep_top1"] == single["ep_top1"] == want


def test_two_rank_ep_server_answers_as_one_device(ep_runs):
    """`python -m ucf_vit_tpu_torch.serve` on (ep 2): rank 0 answers HTTP (two lone
    requests, four at once) while rank 1 follows every batch through the experts'
    all-to-all; the answers against `run_batch` on one device."""
    runs, single, _ = ep_runs
    got = runs["ep_http"]
    assert "error" not in got, got.get("error")
    assert got["returned"] == ["returned", "returned"]
    assert got["stats"]["errors"] == 0
    answers = np.stack([got["answers"][i] for i in range(EP_HTTP_INPUTS)])
    np.testing.assert_allclose(answers, single["ep_http"], atol=EVAL_SERVE_TOL, rtol=0)


@pytest.mark.parametrize("n, m, a", [(4, 2, 2), (2, 4, 2), (2, 6, 3), (8, 4, 4), (3, 4, 2)],
                         ids=str)
def test_global_microbatches_plan_gives_each_rank_its_share(n, m, a):
    """`global_microbatches`' rows, on the global batch of `n` data ranks of `m` rows
    each as its all-gather makes it: every rank's i-th chunk of `a` is its share, in
    rank order, of rows `[i M, (i + 1) M)` of the global batch, as the JAX step and one
    device split it."""
    from ucf_vit_tpu_torch.parallel.train_step import _shares

    whole = torch.arange(n * m)
    q, big = m // a, n * m // a
    for r in range(n):
        local = _shares(whole, n, r, a).tolist()
        assert len(local) == m
        for i in range(a):
            assert local[i * q:(i + 1) * q] == list(range(i * big + r * q, i * big + (r + 1) * q))


def test_shipped_classification_moe_passes_the_trainers_check():
    """imagenet/classification_moe at its shipped (ddp 2, ep 4): the trainer's check
    passes the axes and stops at the world size of a one-process launch; shrunk to two
    blocks it builds with its MoE block second (`moe_every: 2`)."""
    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.train import check_config

    cfg = load_config(os.path.join(REPO, "configs", "imagenet", "classification_moe",
                                   "base_config.yaml"))
    assert cfg.world_size == 8
    with pytest.raises(RuntimeError, match="asks for 8 processes but 1 was launched"):
        check_config(cfg)
    cfg.raw["model"]["net"]["init_args"].update(depth=2, embed_dim=32, num_heads=2)
    model = build_task(cfg)
    assert [b.is_moe for b in model.blocks] == [False, True]
    moe = model.blocks[1].moe_mlp
    assert (moe.num_experts, moe.top_k, moe.capacity_factor) == (8, 2, 1.25)
    assert port_tasks.moe_weight(cfg) == 0.01
