"""The pass after a conv (``tpuvc_torch.ops.epilogue``): its output cast,
bias, residual and activation.

On the CPU: the modules' ``act=`` / ``residual=`` arguments give what their
callers computed before, op for op, and the dispatch sends only CPU tensors
and recording autograd to the plain ops. Marked ``gpu`` (skipped without a
card): the hand-written kernel ``csrc/epilogue.cu`` against the plain ops on
the card, bit for bit. This file imports no JAX; on the card run

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_epilogue.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuvc_torch.models import layers as L
from tpuvc_torch.ops import epilogue as E
from tpuvc_torch.ops.precision import set_compute_dtype

ACTS = [(None, 0.01), ("relu", 0.01), ("leaky_relu", 0.01), ("leaky_relu", 0.1)]
POLICIES = [None, torch.bfloat16]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _randomize(module, seed=0):
    """Seeded weights and non-zero biases (the modules start them at 0)."""
    g = _gen(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module


def _old_act(x, act, slope):
    if act == "relu":
        return F.relu(x)
    if act == "leaky_relu":
        return torch.where(x >= 0, x, slope * x)
    return x


def _bits_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


# -- CPU: the module API ------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("act,slope", ACTS)
@pytest.mark.parametrize("residual", [False, True])
def test_conv_act_equals_act_after_conv(policy, act, slope, residual):
    """``Conv(x, act, slope, residual)`` equals ``act(Conv(x) + residual)``
    bit for bit, under both policies."""
    conv = _randomize(L.Conv(5, 12, kernel=3))
    x = torch.randn(2, 9, 11, 5, generator=_gen(1))
    r = torch.randn(2, 9, 11, 12, generator=_gen(2)) if residual else None
    with set_compute_dtype(policy), torch.no_grad():
        base = conv(x)
        want = _old_act(base + r if residual else base, act, slope)
        got = conv(x, act, slope, residual=r)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("kind", ["Deconv", "SubpelConv", "SubpelConv_r4"])
def test_upsampling_act_equals_act_after(policy, act, kind):
    """``Deconv`` and ``SubpelConv`` with ``act``: the activation after the
    layer (after the pixel shuffle: it commutes with it); leaky at 0.01,
    the slope of every caller of these layers."""
    layer = _randomize(L.Deconv(6, 4, kernel=5, stride=2) if kind == "Deconv"
                       else L.SubpelConv(6, 4, r=4 if kind.endswith("r4") else 2))
    x = torch.randn(2, 5, 7, 6, generator=_gen(3))
    with set_compute_dtype(policy), torch.no_grad():
        want = _old_act(layer(x), act, 0.01)
        got = layer(x, act)
    assert _bits_equal(got, want)


def _old_forward(module, x):
    """The modules' forwards as their callers wrote them before the
    activations moved into the convs' epilogues."""
    m = module
    if isinstance(m, L.ResidualBlock):
        out = _old_act(m.Conv_0(x), "leaky_relu", 0.01)
        out = _old_act(m.Conv_1(out), "leaky_relu", 0.01)
        return out + (m.Conv_2(x) if hasattr(m, "Conv_2") else x)
    if isinstance(m, L.ResidualBlockWithStride):
        out = _old_act(m.Conv_0(x), "leaky_relu", 0.01)
        return m.GDN_0(m.Conv_1(out)) + m.Conv_2(x)
    if isinstance(m, L.ResidualBlockUpsample):
        out = _old_act(m.SubpelConv_0(x), "leaky_relu", 0.01)
        return m.GDN_0(m.Conv_0(out)) + m.SubpelConv_1(x)
    if isinstance(m, L.ResidualUnit):
        out = F.relu(m.Conv_1(F.relu(m.Conv_0(x))))
        return F.relu(m.Conv_2(out) + x)
    if isinstance(m, L.ResidualBottleneckBlock):
        return m.Conv_2(F.relu(m.Conv_1(F.relu(m.Conv_0(x))))) + x
    from tpuvc_torch.models import spynet, unet

    if isinstance(m, spynet.BasicBlock):
        for i in range(4):
            x = F.relu(getattr(m, f"conv{i}")(x))
        return m.conv4(x)
    if isinstance(m, unet.MaskUNet):
        c1 = F.relu(m.Conv_0(x))
        c2 = F.relu(m.Conv_1(unet._maxpool2(c1)))
        c3 = F.relu(m.Conv_2(unet._maxpool2(c2)))
        t = F.relu(m.Conv_3(unet._maxpool2(c3)))
        t = F.relu(m.Conv_4(torch.cat([unet._up2(t), c3], dim=-1)))
        t = F.relu(m.Conv_5(torch.cat([unet._up2(t), c2], dim=-1)))
        t = F.relu(m.Conv_6(torch.cat([unet._up2(t), c1], dim=-1)))
        return torch.sigmoid(m.Conv_7(t))
    if isinstance(m, unet.UNet):
        convs = iter(getattr(m, f"Conv_{i}") for i in range(m.n_convs))
        skips = []
        for i in range(m.depth):
            x = unet._lrelu(next(convs)(x))
            x = unet._lrelu(next(convs)(x))
            if i < m.depth - 1:
                skips.append(x)
                x = unet._avgpool2(x)
        x = unet._lrelu(next(convs)(x))
        for i in reversed(range(m.depth - 1)):
            x = torch.cat([next(convs)(unet._up2(x)), skips[i]], dim=-1)
            x = unet._lrelu(next(convs)(x))
            x = unet._lrelu(next(convs)(x))
        return next(convs)(x)
    raise TypeError(type(m))


def _modules():
    from tpuvc_torch.models import spynet, unet

    return {
        "ResidualBlock": (lambda: L.ResidualBlock(6, 8), 6),
        "ResidualBlockWithStride": (lambda: L.ResidualBlockWithStride(6, 8), 6),
        "ResidualBlockUpsample": (lambda: L.ResidualBlockUpsample(6, 8), 6),
        "ResidualUnit": (lambda: L.ResidualUnit(8), 8),
        "ResidualBottleneckBlock": (lambda: L.ResidualBottleneckBlock(8), 8),
        "BasicBlock": (lambda: spynet.BasicBlock(), 8),
        "MaskUNet": (lambda: unet.MaskUNet(6, ch=4), 6),
        "UNet": (lambda: unet.UNet(5, out_channels=4, depth=3, wf=2), 5),
    }


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(_modules()))
def test_module_forward_equals_its_old_composition(policy, name):
    """Each module whose convs now take their activation (and residual) in
    the epilogue gives its old forward's bits."""
    make, cin = _modules()[name]
    module = _randomize(make())
    x = torch.randn(2, 16, 24, cin, generator=_gen(4))
    with set_compute_dtype(policy), torch.no_grad():
        assert _bits_equal(module(x), _old_forward(module, x))


def test_spynet_block_takes_the_residual_in_its_last_conv():
    """SPyNet's refinement ``block(inp) + up`` as ``block(inp, residual=up)``."""
    from tpuvc_torch.models.spynet import BasicBlock

    block = _randomize(BasicBlock())
    x = torch.randn(1, 12, 16, 8, generator=_gen(5))
    up = torch.randn(1, 12, 16, 2, generator=_gen(6))
    with torch.no_grad():
        assert _bits_equal(block(x, residual=up), _old_forward(block, x) + up)


@pytest.mark.parametrize("name", ["ResidualUnit", "ResidualBottleneckBlock", "UNet"])
def test_module_gradients_equal_the_old_composition(name):
    """While autograd records, the plain ops run in the old order: the
    same outputs and the same gradients (training's bits)."""
    make, cin = _modules()[name]
    module = _randomize(make())
    x = torch.randn(1, 8, 8, cin, generator=_gen(7))
    grads = []
    for fwd in (module, lambda t: _old_forward(module, t)):
        module.zero_grad()
        xi = x.clone().requires_grad_(True)
        out = fwd(xi)
        out.square().sum().backward()
        grads.append([xi.grad.clone()] + [p.grad.clone() for p in module.parameters()])
    for a, b in zip(*grads):
        assert _bits_equal(a, b)


def test_plain_version_is_the_old_ops_in_order():
    """``epilogue_plain``: the cast, + bias, + residual, the activation;
    ``dtype`` the output's (a transposed conv returns its input's)."""
    y = torch.randn(2, 3, 4, 5, generator=_gen(8)).to(torch.bfloat16)
    b = torch.randn(3, generator=_gen(9))
    r = torch.randn(2, 4, 5, 3, generator=_gen(10))
    want = torch.where((y.permute(0, 2, 3, 1).float() + b + r) >= 0,
                       y.permute(0, 2, 3, 1).float() + b + r,
                       0.1 * (y.permute(0, 2, 3, 1).float() + b + r))
    assert _bits_equal(E.epilogue_plain(y, b, "leaky_relu", 0.1, r), want)
    y64 = y.double()
    assert E.epilogue_plain(y64, dtype=torch.float64).dtype == torch.float64


def test_epilogue_with_nothing_to_compute_is_the_view():
    """No bias, residual or activation, and the output dtype already: the
    NHWC view, as a float32 transposed conv returned it."""
    y = torch.randn(1, 3, 4, 5)
    out = E.epilogue(y)
    assert out.data_ptr() == y.data_ptr() and out.shape == (1, 4, 5, 3)


def test_epilogue_on_the_cpu_never_launches():
    before = (E.epilogue_kernel.launches, E.epilogue_kernel.act_launches)
    with torch.no_grad():
        E.epilogue(torch.randn(1, 3, 4, 5), torch.randn(3), "relu")
    assert (E.epilogue_kernel.launches, E.epilogue_kernel.act_launches) == before


def test_epilogue_on_a_non_cpu_tensor_never_runs_the_plain_version(monkeypatch):
    """Only a CPU tensor (or recording autograd) takes the plain ops; any
    other device goes to the kernel wrapper, which launches or raises (here:
    a meta tensor)."""
    def plain(*args, **kwargs):
        raise AssertionError("epilogue_plain ran on a non-CPU tensor")

    monkeypatch.setattr(E, "epilogue_plain", plain)
    y = torch.empty((1, 3, 4, 5), device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        E.epilogue(y, torch.empty(3, device="meta"), "relu")
    with pytest.raises(ValueError, match="CUDA"):
        E.epilogue_kernel(torch.zeros((1, 3, 4, 5)), torch.zeros(3))


def test_activate_refuses_an_unknown_activation():
    with pytest.raises(ValueError, match="unknown activation"):
        E.activate(torch.zeros(2), "gelu")


@pytest.mark.parametrize("case,dense", [
    ("nhwc", True), ("nchw", True), ("one_channel", True), ("strided", False),
    ("overlapping", False)])
def test_dense_layouts(case, dense):
    """The layouts the kernel walks as memory: any order of the dims that
    fills its span once; channel i at (i / stride_C) % C."""
    base = torch.zeros(2, 6, 7, 5)
    t = {"nhwc": base.permute(0, 3, 1, 2), "nchw": base.permute(0, 3, 1, 2).contiguous(),
         "one_channel": torch.zeros(2, 1, 6, 7).permute(0, 2, 3, 1).permute(0, 3, 1, 2),
         "strided": base[:, ::2].permute(0, 3, 1, 2),
         "overlapping": torch.zeros(5).expand(2, 6, 7, 5)}[case]
    assert E._dense(t) is dense
    if dense and t.shape[1] > 1:
        flat = torch.arange(t.numel()).reshape(-1)
        strided = torch.as_strided(flat, t.shape, t.stride())
        C, s = t.shape[1], t.stride(1)
        channel = torch.arange(C).view(1, C, 1, 1).expand(t.shape)
        assert torch.equal((strided // s) % C, channel)


# -- the card: the kernel against the plain ops -------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuvc_torch.ops.precision import set_deterministic

    set_deterministic()
    return torch.device("cuda")


def _special_bits(n, dtype, rng):
    """``n`` values of ``dtype`` of which about a quarter are -0.0, +-0, NaNs
    with payloads, +-inf and subnormals, the rest ordinary."""
    if dtype == torch.bfloat16:
        special = np.array([0x8000, 0x0000, 0x7FC0, 0x7FC1, 0xFFC3, 0x7F81, 0x7F80, 0xFF80,
                            0x0001, 0x807F, 0x0040], dtype=np.uint16)
        bits = (torch.randn(n) * 4).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        int_t = torch.int16
    else:
        special = np.array([0x80000000, 0x00000000, 0x7FC00000, 0x7FC00001, 0xFFC00003,
                            0x7F800001, 0x7F800000, 0xFF800000, 0x00000001, 0x807FFFFF,
                            0x00400000], dtype=np.uint32)
        bits = (torch.randn(n) * 4).view(torch.int32).numpy().view(np.uint32)
        int_t = torch.int32
    bits = bits.copy()
    pick = rng.random(n) < 0.25
    bits[pick] = rng.choice(special, int(pick.sum()))
    return torch.from_numpy(bits.view(np.int16 if int_t == torch.int16 else np.int32)).view(dtype)


def _conv_output(shape, layout, dtype, device, seed=0, offset=0):
    """A conv's NCHW output (B, C, H, W) in cuDNN's layouts: channels-last
    memory or NCHW-contiguous; ``offset`` elements into its storage."""
    B, C, H, W = shape
    n = B * C * H * W
    flat = _special_bits(n + offset, dtype, np.random.default_rng(seed)).to(device)[offset:]
    if layout == "channels_last":
        return flat.view(B, H, W, C).permute(0, 3, 1, 2)
    return flat.view(B, C, H, W)


def _counts():
    """The kernel's launches: all, those that applied the activation, those
    that left the residual and the activation to the plain ops."""
    k = E.epilogue_kernel
    return k.launches, k.act_launches, k.partial_launches


def _bias(C, device, seed=1):
    b = torch.randn(C, generator=_gen(seed))
    b[0] = -0.0
    return b.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 3, 16, 32, 64, 128, 192])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act,slope", ACTS)
def test_epilogue_kernel_matches_plain(cuda, C, layout, dtype, residual, act, slope):
    """Bit for bit the plain ops on the card (cast, + bias, + residual, the
    activation), with -0.0, NaNs, infinities and subnormals in the input,
    at sizes that are not a multiple of the 8-element vector, in both of
    cuDNN's output layouts; the output laid out as the plain version's."""
    y = _conv_output((2, C, 7, 13), layout, dtype, cuda, seed=C)
    b = _bias(C, cuda)
    r = None
    if residual:
        r = torch.randn(2, 7, 13, C, generator=_gen(2)).to(cuda)
        r.view(-1)[::5] = -0.0
    before = _counts()
    with torch.no_grad():
        out = E.epilogue(y, b, act, slope, r)
        ref = E.epilogue_plain(y, b, act, slope, r)
    torch.cuda.synchronize()
    # one launch does it all, but for a residual beside an NCHW output, or
    # an activation after an NCHW output with a size-one dimension
    partial = layout == "nchw" and (residual or (C == 1 and act is not None))
    assert _counts() == (before[0] + 1, before[1] + int(act is not None and not partial),
                         before[2] + int(partial))
    assert out.stride() == ref.stride()
    assert _bits_equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("act,slope", ACTS)
@pytest.mark.parametrize("C", [1, 3])
def test_epilogue_kernel_nchw_output_takes_the_plain_residual_and_activation(cuda, act, slope, C):
    """An NCHW-contiguous output (or a residual in its order): the launch
    casts and adds the bias, then the plain residual add and activation
    give the plain version's bits and strides, size-one dimensions' too."""
    y = _conv_output((2, C, 9, 11), "nchw", torch.bfloat16, cuda)
    r = torch.randn(2, C, 9, 11, generator=_gen(3)).to(cuda).permute(0, 2, 3, 1)
    before = _counts()
    with torch.no_grad():
        out = E.epilogue(y, _bias(C, cuda), act, slope, r)
        ref = E.epilogue_plain(y, _bias(C, cuda), act, slope, r)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1], before[2] + 1)
    assert out.stride() == ref.stride()
    assert _bits_equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [3, 64])
def test_epilogue_kernel_misaligned_operands(cuda, dtype, C):
    """Operands off a 16-byte boundary take the one-element path; a
    misaligned bias the per-element channel walk."""
    y = _conv_output((1, C, 5, 9), "channels_last", dtype, cuda, offset=1)
    assert y.data_ptr() % 16
    b = torch.randn(C + 1, generator=_gen(4)).to(cuda)[1:]
    r = torch.randn(5 * 9 * C + 1, generator=_gen(5)).to(cuda)[1:].view(1, 5, 9, C)
    with torch.no_grad():
        for args in ((b, "relu", 0.01, None), (b, "leaky_relu", 0.1, r), (None, "relu", 0.01, r)):
            out = E.epilogue(y, *args)
            assert _bits_equal(out, E.epilogue_plain(y, *args))
    b_aligned = _bias(C, cuda)
    y_aligned = _conv_output((1, C, 5, 9), "channels_last", dtype, cuda)
    with torch.no_grad():
        assert _bits_equal(E.epilogue(y_aligned, b, "relu"), E.epilogue_plain(y_aligned, b, "relu"))
        assert _bits_equal(E.epilogue(y_aligned, b_aligned), E.epilogue_plain(y_aligned, b_aligned))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,act", [((8, 64, 1088, 1920), "relu"),
                                       ((8, 128, 1088, 1920), "relu")])
def test_epilogue_kernel_at_spynets_full_resolution(cuda, shape, act):
    """SPyNet's first 7x7 conv at 1080p, batch 8 (1.07e9 elements, 32-bit
    indices) and twice its channels (2.1e9, past 2^31: 64-bit indices)."""
    y = torch.randn(shape[0], shape[2], shape[3], shape[1], device=cuda,
                    dtype=torch.bfloat16).permute(0, 3, 1, 2)
    b = _bias(shape[1], cuda)
    with torch.no_grad():
        out = E.epilogue(y, b, act)
        ref = E.epilogue_plain(y, b, act)
        torch.cuda.synchronize()
        assert _bits_equal(out, ref)
    del out, ref, y
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_epilogue_kernel_rejects_what_it_does_not_take(cuda):
    y = _conv_output((1, 4, 3, 5), "channels_last", torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        E.epilogue_kernel(y.half())
    with pytest.raises(ValueError, match="dense"):
        E.epilogue_kernel(torch.zeros(1, 4, 6, 5, device=cuda)[:, :, ::2])
    with pytest.raises(ValueError, match="bias"):
        E.epilogue_kernel(y, torch.zeros(3, device=cuda))
    with pytest.raises(ValueError, match="residual"):
        E.epilogue_kernel(y, None, None, 0.01, torch.zeros(1, 3, 5, 4, device=cuda).double())
    with pytest.raises(ValueError, match="unknown activation"):
        E.epilogue_kernel(y, None, "gelu")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_layers_launch_the_kernel_only_while_autograd_does_not_record(cuda, policy):
    """Under no_grad every Conv and (bf16) Deconv launches the kernel once,
    with the bits of the plain ops; while autograd records (training), none
    does."""
    conv = _randomize(L.Conv(8, 16, kernel=3)).to(cuda)
    deconv = _randomize(L.Deconv(16, 8, kernel=5, stride=2)).to(cuda)
    x = torch.randn(2, 12, 20, 8, generator=_gen(6)).to(cuda)
    with set_compute_dtype(policy):
        before = E.epilogue_kernel.launches
        with torch.no_grad():
            h = conv(x, "relu")
            out = deconv(h, "leaky_relu")
        launched = E.epilogue_kernel.launches - before
        assert launched == 2
        before = E.epilogue_kernel.launches
        h2 = conv(x, "relu")
        out2 = deconv(h2, "leaky_relu")
        out2.sum().backward()
        assert E.epilogue_kernel.launches == before
    torch.cuda.synchronize()
    assert _bits_equal(out, out2.detach())


def test_counters_report_the_epilogue_launches():
    """``obs.counters()`` carries the kernel's three launch counts."""
    from tpuvc_torch import obs

    k = E.epilogue_kernel
    c = obs.counters()
    assert (c["epilogue.launches"], c["epilogue.launches.act"],
            c["epilogue.launches.partial"]) == (k.launches, k.act_launches, k.partial_launches)
