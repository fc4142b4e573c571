"""Every hand-written kernel as a ``torch.library`` custom op
(``ops/library.py``), on the CPU.

* ``torch.library.opcheck`` on ``awseg::sr_attention`` (K1),
  ``awseg::seg_core`` (K2) and ``awseg::window_attention`` (K15) at
  ragged shapes (``awseg::bn_act``, K12, in
  ``tests/test_torch_bn_act.py``), f32 and bf16: schema, fake
  implementation and the traced (dynamic-shape) dispatch all agree with
  the CPU kernel. On the ops with no fake implementation (K3–K10, the
  scatter and the train cores' gradients), the checks that need none: the
  schema and the autograd registration.
* Each op has a CPU and a CUDA kernel and nothing else: no default
  implementation that would run plain code on another device.
* Each op's CPU route equals its plain version bit for bit in f32 and
  bf16, and so does its gradient the plain version's autograd (K7, K9);
  K6 equals autograd through K1's plain version, K8 and K10 their plain
  versions.
* The exported serving graph of the ensemble holds exactly 8
  ``awseg.sr_attention`` nodes (one per MiT block) and 1
  ``awseg.seg_core``, 66 ``awseg.bn_act`` (every BN of both members),
  and no softmax of the attention: on the CPU, the
  guard against a trace that records the plain version, which a moved
  artifact would then run on the card.
* ``_device.const`` after an export in the same process serves real
  tables: ``normalize_imagenet``, an upconv and the seg head's phase passes
  equal a fresh process's values, and the cache holds no FakeTensor.
* The public functions call the ops with a gradient or without one; on
  the CPU that equals the plain versions bit for bit, and the gradients
  (K1's from K6's op, K2's from the eval kernels' shared rule) equal the
  plain versions' autograd bit for bit.
"""

import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from awsegbench_torch import _device
from awsegbench_torch.data.pipeline import normalize_imagenet
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.ops import attention, headkernels, splat
from awsegbench_torch.ops import window_attention
from awsegbench_torch.ops import depthkernels_train as dk
from awsegbench_torch.ops import headkernels_train as ht
from awsegbench_torch.ops.upconv import upsample_conv3x3
from awsegbench_torch.serving import build_serving_fn

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
# the ops with a fake implementation (K1, K2, K12, K11, K15), then those
# without
OPS = ('awseg::sr_attention', 'awseg::seg_core', 'awseg::bn_act',
       'awseg::ms_deform_attn', 'awseg::window_attention',
       'awseg::splat_coverage_batched',
       'awseg::splat_coverage_windowed', 'awseg::splat_coverage_tiled',
       'awseg::sr_attention_backward', 'awseg::seg_core_train',
       'awseg::seg_core_train_backward', 'awseg::seg_core_train_grad',
       'awseg::d1_core_train', 'awseg::d1_core_train_backward',
       'awseg::d1_core_train_grad', 'awseg::neighbor_pp_adjoint')


def _rand(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _attention_inputs(g, n, m, d, dtype):
    return tuple(_rand(s, dtype, i) for i, s in
                 enumerate(((g, n, d), (g, m, d), (g, m, d))))


def _seg_core_inputs(b, h, w, c, nc, dtype):
    P = _rand((b, h, w, 9, c), dtype, 0)
    a1 = _rand((c,), torch.float32, 1).abs() + 0.5
    return (P, a1, _rand((c,), torch.float32, 2),
            _rand((c, nc), dtype, 3) / c ** 0.5,
            _rand((nc,), torch.float32, 4))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('g,n,m,d', [(3, 37, 5, 32), (2, 50, 13, 64)])
def test_opcheck_sr_attention(g, n, m, d, dtype):
    q, k, v = _attention_inputs(g, n, m, d, dtype)
    torch.library.opcheck(torch.ops.awseg.sr_attention.default,
                          (q, k, v, d ** -0.5))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,h,w,c,nc,r', [(2, 3, 5, 16, 5, 4),
                                          (1, 2, 3, 32, 19, 8)])
def test_opcheck_seg_core(b, h, w, c, nc, r, dtype):
    torch.library.opcheck(torch.ops.awseg.seg_core.default,
                          (*_seg_core_inputs(b, h, w, c, nc, dtype), r))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,hp,wp,heads,window,shift', [
    (2, 14, 21, 3, 7, 3), (1, 5, 10, 2, 5, 0), (3, 4, 4, 1, 2, 1)])
def test_opcheck_window_attention(b, hp, wp, heads, window, shift, dtype):
    """K15's op at ragged shapes (windows of 7, 5 and 2, one or several a
    side, 1 to 3 heads): schema, fake, autograd registration and the traced
    dispatch; the op's CPU route equals its plain version bit for bit."""
    qkv = _rand((b, hp, wp, 3 * heads * 32), dtype, 0)
    table = _rand(((2 * window - 1) ** 2, heads), dtype, 1)
    args = (qkv, table, heads, window, shift, 32 ** -0.5)
    torch.library.opcheck(torch.ops.awseg.window_attention.default, args)
    got = window_attention.window_attention(*args)
    assert got.dtype == dtype and got.shape == (b, hp, wp, heads * 32)
    torch.testing.assert_close(
        got, window_attention.window_attention_plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize('name', OPS)
def test_ops_have_cpu_and_cuda_kernels_only(name):
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(name, 'CPU') and has(name, 'CUDA')
    for key in ('CompositeExplicitAutograd', 'CompositeImplicitAutograd',
                'XPU', 'MPS', 'PrivateUse1'):
        assert not has(name, key), key


@pytest.fixture(scope='module')
def exported():
    """The bf16 serving forward of a tiny ensemble at 32×64, exported with
    a symbolic batch, as ``serving.export_serving`` traces it."""
    torch.manual_seed(0)
    serve = build_serving_fn(EnsembleModel(num_classes=5).eval(),
                             precision='bf16')
    return torch.export.export(
        serve, (torch.zeros((2, 32, 64, 3), dtype=torch.uint8),),
        dynamic_shapes={'images_u8': {0: torch.export.Dim('b', min=1)}},
        strict=False)


def _call_nodes(program):
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            yield from (n for n in gm.graph.nodes
                        if n.op == 'call_function')


def test_exported_graph_holds_the_ops(exported):
    nodes = list(_call_nodes(exported))
    counts = Counter(str(n.target) for n in nodes)
    assert counts['awseg.sr_attention.default'] == 8
    assert counts['awseg.seg_core.default'] == 1
    assert counts['awseg.bn_act.default'] == 66
    for n in nodes:
        if 'softmax' in str(n.target):
            stack = ' '.join(str(v) for v in
                             n.meta.get('nn_module_stack', {}).values())
            assert 'EfficientSelfAttention' not in stack
            assert tuple(n.meta['val'].shape) == (2,)   # ensemble weights
    # the batch stayed symbolic
    assert len(exported.range_constraints) == 1


_FRESH = '''
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from awsegbench_torch.data.pipeline import normalize_imagenet
from awsegbench_torch.ops.upconv import upsample_conv3x3
from awsegbench_torch.ops.headkernels import phase_passes
x = torch.from_numpy(np.load({path!r}))
np.savez({out!r}, norm=normalize_imagenet(x[..., :3].to(torch.uint8)).numpy(),
         up=upsample_conv3x3(x, torch.ones(3, 3, 4, 2), None, 4).numpy(),
         pp=phase_passes(torch.ones(1, 1, 1, 81, 2), 4, False).numpy())
'''


def test_const_serves_real_tables_after_an_export(exported, tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (1, 4, 6, 4)).astype(np.float32))
    np.save(tmp_path / 'x.npy', x.numpy())
    code = _FRESH.format(root=str(ROOT), path=str(tmp_path / 'x.npy'),
                         out=str(tmp_path / 'fresh.npz'))
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    fresh = np.load(tmp_path / 'fresh.npz')

    got = {'norm': normalize_imagenet(x[..., :3].to(torch.uint8)),
           'up': upsample_conv3x3(x, torch.ones(3, 3, 4, 2), None, 4),
           'pp': headkernels.phase_passes(torch.ones(1, 1, 1, 81, 2), 4,
                                          False)}
    for key, t in got.items():
        assert type(t) is torch.Tensor, key
        np.testing.assert_array_equal(t.numpy(), fresh[key])
    assert _device._CONSTS
    assert all(type(t) is torch.Tensor for t in _device._CONSTS.values())


def test_no_grad_branch_is_the_op_and_equals_plain():
    q, k, v = _attention_inputs(4, 33, 7, 32, torch.float32)
    with torch.no_grad():
        torch.testing.assert_close(attention.sr_attention(q, k, v, 0.17),
                                   attention.sr_attention_plain(q, k, v, 0.17),
                                   rtol=0, atol=0)
    core = _seg_core_inputs(2, 2, 3, 16, 5, torch.bfloat16)
    with torch.inference_mode():
        torch.testing.assert_close(headkernels.seg_core(*core, 4),
                                   headkernels.seg_core_plain(*core, 4),
                                   rtol=0, atol=0)
    # traced without a gradient, the public functions record the ops
    gm = torch.fx.experimental.proxy_tensor.make_fx(
        lambda q, k, v, *c: (attention.sr_attention(q, k, v, 0.17),
                             headkernels.seg_core(*c, 4)))(q, k, v, *core)
    targets = {str(n.target) for n in gm.graph.nodes
               if n.op == 'call_function'}
    assert {'awseg.sr_attention.default',
            'awseg.seg_core.default'} <= targets


def test_grad_branch_keeps_autograd():
    """With a gradient the public functions call the same ops, and the
    gradients equal the plain versions' autograd bit for bit: K1's through
    the op ``awseg::sr_attention_backward``, K2's through the eval
    kernels' shared rule."""
    q, k, v = (t.requires_grad_() for t in
               _attention_inputs(2, 9, 4, 32, torch.float32))
    out = attention.sr_attention(q, k, v, 0.2)
    assert 'awseg_sr_attention' in type(out.grad_fn).__name__
    out.sum().backward()
    dq = q.grad.clone()
    q.grad = None
    attention.sr_attention_plain(q, k, v, 0.2).sum().backward()
    torch.testing.assert_close(dq, q.grad, rtol=0, atol=0)
    P, a1, c1, wp, bp = _seg_core_inputs(1, 2, 2, 16, 3, torch.float32)
    P.requires_grad_()
    out = headkernels.seg_core(P, a1, c1, wp, bp, 4)
    assert 'awseg_seg_core' in type(out.grad_fn).__name__
    out.sum().backward()
    dP = P.grad.clone()
    P.grad = None
    headkernels.seg_core_plain(P, a1, c1, wp, bp, 4).sum().backward()
    assert dP.abs().sum() > 0
    torch.testing.assert_close(dP, P.grad, rtol=0, atol=0)


# ------------------------------------------- the ops added to the table

def _autograd(fn, args, grad, wrt):
    """``fn(*args)`` and plain ``torch.autograd.grad`` of it for ``grad``
    with respect to ``args[i]``, i in ``wrt``."""
    leaves = [a.detach().requires_grad_() if i in wrt else a
              for i, a in enumerate(args)]
    out = fn(*leaves)
    return [out, *torch.autograd.grad(out, [leaves[i] for i in wrt], grad)]


def _train_core_inputs(dtype, nc=None):
    """Tiny K7 (with ``nc``) or K9 operands: P [1, 2, 3, 9, 16], a1 of both
    signs, a seed, rate 0.1, r 4."""
    P = _rand((1, 2, 3, 9, 16), dtype, 0)
    a1, c1 = _rand((16,), torch.float32, 1), _rand((16,), torch.float32, 2)
    seed = torch.tensor([5], dtype=torch.int32)
    if nc is None:
        return P, a1, c1, seed, 0.1, 4
    return (P, a1, c1, _rand((16, nc), dtype, 3) / 4,
            _rand((nc,), torch.float32, 4), seed, 0.1, 4)


def _op_case(name, dtype):
    """(what the public function gives on the CPU, what it must equal)."""
    if name in ('seg_core_train', 'd1_core_train'):
        args = _train_core_inputs(dtype, 5 if name == 'seg_core_train'
                                  else None)
        fn = getattr(ht if name == 'seg_core_train' else dk, name)
        plain = getattr(ht if name == 'seg_core_train' else dk,
                        f'{name}_plain')
        wrt = range(5 if name == 'seg_core_train' else 3)
        dy = _rand(plain(*args).shape, dtype, 9)
        return _autograd(fn, args, dy, wrt), _autograd(plain, args, dy, wrt)
    if name == 'sr_attention_backward':
        q, k, v = _attention_inputs(3, 37, 5, 32, dtype)
        dout = _rand((3, 37, 32), dtype, 7)
        return (attention.sr_attention_backward(q, k, v, dout, 0.3),
                _autograd(attention.sr_attention_plain, (q, k, v, 0.3), dout,
                          range(3))[1:])
    if name == 'seg_core_train_backward':
        args = _train_core_inputs(dtype, 5)
        dy = _rand((1, 8, 12, 5), dtype, 9)
        return (ht.seg_core_train_backward(*args[:6], dy, *args[6:]),
                ht.seg_core_train_backward_plain(*args[:6], dy, *args[6:]))
    if name == 'd1_core_train_backward':
        args = _train_core_inputs(dtype)
        dd1 = _rand((1, 8, 12, 16), dtype, 9)
        return (dk.d1_core_train_backward(*args[:4], dd1, *args[4:]),
                dk.d1_core_train_backward_plain(*args[:4], dd1, *args[4:]))
    if name == 'neighbor_pp_adjoint':
        dpp = _rand((1, 3, 2, 81, 8), dtype, 0)
        return ([ht.neighbor_pp_adjoint(dpp)],
                [ht._neighbor_pp_adjoint(dpp).to(dtype)])
    # the splat masks take f32 drops at any dtype of the image
    params = _rand((2, 6, 8), torch.float32, 0).abs() * 12
    params[..., 5] = 1.0
    if name == 'splat_coverage_batched':
        return ([splat.splat_coverage_batched(params, 17, 30)],
                [splat.splat_coverage_plain(params, 17, 30)])
    return ([getattr(splat, name)(params[0], 17, 30)],
            [splat.splat_coverage_plain(params[:1], 17, 30)[0]])


NEW_OPS = ('sr_attention_backward', 'seg_core_train',
           'seg_core_train_backward', 'd1_core_train',
           'd1_core_train_backward', 'neighbor_pp_adjoint',
           'splat_coverage_batched', 'splat_coverage_windowed',
           'splat_coverage_tiled')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', NEW_OPS)
def test_op_and_its_gradient_equal_the_plain_version(name, dtype):
    got, want = _op_case(name, dtype)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _op_args(name):
    """Arguments for ``awseg::<name>`` at tiny shapes, floats requiring a
    gradient where the op has one."""
    if name.startswith('splat'):
        params = _rand((2, 6, 8), torch.float32, 0).abs() * 12
        return (params if name.endswith('batched') else params[0], 9, 14)
    if name == 'sr_attention_backward':
        return (*_attention_inputs(2, 9, 4, 32, torch.float32),
                _rand((2, 9, 32), torch.float32, 5), 0.3)
    if name == 'neighbor_pp_adjoint':
        return (_rand((1, 2, 2, 81, 8), torch.float32, 0),)
    seg = name.startswith('seg')
    args = list(_train_core_inputs(torch.float32, 5 if seg else None))
    if name.endswith('_train'):
        n = 5 if seg else 3
        return (*(a.requires_grad_() for a in args[:n]), *args[n:])
    grad = _rand((1, 8, 12, 5 if seg else 16), torch.float32, 9)
    n = 6 if seg else 4
    return (*args[:n], grad, *args[n:])


@pytest.mark.parametrize('name', [op.split('::')[1] for op in OPS[5:]])
def test_opcheck_ops_without_a_fake(name):
    torch.library.opcheck(getattr(torch.ops.awseg, name).default,
                          _op_args(name),
                          test_utils=('test_schema',
                                      'test_autograd_registration'))
