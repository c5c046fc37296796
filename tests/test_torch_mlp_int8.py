"""The port's fused-MLP and W8A8 int8 GEMM ops against the JAX package, on the
CPU: the plain versions (which the wrappers take for CPU tensors) against the
Pallas kernels in interpret mode and against their plain-XLA references, on
inputs from numpy seeds. The CUDA kernels are held against the same plain
versions on the card (`tests/test_torch_flash_cuda.py`, `chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
