"""
The PyTorch port's local layers (`neurite_tpu_torch.layers.local`) and the
config #3 training step against the JAX package's.

Every layer gets the flax layer's parameters through `convert` and must
give flax's `apply` outputs and gradients: float32 within rtol 1e-5 and
atol 1e-5 (sums in another order). The LocallyConnected layers run in the
keras, transposed and 'auto' layouts, in 1-3 dims, and once against the
JAX layer's Pallas route in interpret mode (`NEURITE_PALLAS_LC`). The
initializers must draw what flax draws (the std within 5 %). A config #3
step (UNet trunk + LocallyConnected3D head, MSE, Adam 1e-4) at 16^3 in
float32 must match JAX's from the same weights: the loss within rtol 1e-5,
each gradient and each parameter after one Adam step within 1e-4 of its
largest magnitude. On the CPU no kernel launches; on the card (`cuda`
tests) a step launches K7, K8 and K9 once each.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu.layers import local as jlocal  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert, training  # noqa: E402
from neurite_tpu_torch.layers import local  # noqa: E402
from neurite_tpu_torch.ops import _build, lc_tap  # noqa: E402

torch.set_num_threads(1)
K0 = jax.random.PRNGKey(0)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def _check_layer(jlayer, tlayer, x, rtol=1e-5, atol=1e-5):
    """Load flax's parameters into the port's layer; compare outputs and
    the gradients of sum(y * gy) with respect to x and every parameter."""
    params = jax.jit(jlayer.init)(K0, jnp.asarray(x))['params']
    convert.load_flax_params(tlayer, params)

    def apply(p, a):
        return jlayer.apply({'params': p}, a)

    shape = jax.eval_shape(apply, params, x).shape
    gy = np.random.default_rng(99).normal(size=shape).astype(np.float32)
    y, (gp, gx) = _value_and_vjp(apply, (params, jnp.asarray(x)), gy)
    xt = torch.tensor(x, requires_grad=True)
    yt = tlayer(xt)
    assert tuple(yt.shape) == y.shape
    np.testing.assert_allclose(yt.detach().float().numpy(),
                               np.asarray(y, np.float32), rtol=rtol,
                               atol=atol)
    (yt * torch.from_numpy(gy).to(yt.dtype)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=rtol,
                               atol=atol)
    got, want = _leaves(convert.to_flax_params(tlayer, grad=True)), \
        _leaves(gp)
    assert got.keys() == want.keys()
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=rtol, atol=atol,
                                   err_msg='/'.join(p))


def _value_and_vjp(f, primals, ct):
    """f's value at `primals` and the vjp of `ct` (in the value's dtype),
    as one jitted program (op by op, flax's layers compile every op)."""
    def run(primals, ct):
        y, vjp = jax.vjp(f, *primals)
        return y, vjp(ct.astype(y.dtype))
    return jax.jit(run)(primals, jnp.asarray(ct))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (rank, spatial, C, filters, kernel_size, strides, padding, layout, act)
LC_CASES = [
    (3, (5, 6, 4), 3, 2, 3, 1, 'same', 'keras', None),
    (3, (5, 6, 4), 2, 2, 3, 1, 'valid', 'transposed', None),
    (3, (6, 5, 4), 3, 1, 3, 1, 'same', 'auto', 'relu'),
    (3, (6, 6, 5), 2, 2, (3, 1, 3), 2, 'same', 'auto', None),
    (2, (7, 9), 3, 2, 3, 2, 'same', 'keras', None),
    (2, (7, 9), 3, 1, (3, 5), 1, 'valid', 'transposed', None),
    (1, (11,), 2, 1, 3, 1, 'same', 'auto', 'tanh'),
]


@pytest.mark.parametrize('case', LC_CASES, ids=str)
def test_locally_connected_matches_flax(case):
    rank, sp, C, filters, ks, st, padding, layout, act = case
    jact = {None: None, 'relu': jax.nn.relu, 'tanh': jnp.tanh}[act]
    jl = jlocal.LocallyConnected(filters=filters, kernel_size=ks, rank=rank,
                                 strides=st, padding=padding,
                                 kernel_layout=layout, activation=jact)
    cls = {1: local.LocallyConnected1D, 2: local.LocallyConnected2D,
           3: local.LocallyConnected3D}[rank]
    tl = cls(filters=filters, kernel_size=ks, input_shape=(*sp, C),
             strides=st, padding=padding, kernel_layout=layout,
             activation=act, device='cpu')
    want_t = (layout == 'transposed'
              or (layout == 'auto' and filters == 1 and st == 1))
    assert tl.transposed == want_t
    _check_layer(jl, tl, _x((2, *sp, C)))


def test_locally_connected_bf16_params_and_compute():
    """param_dtype=bf16 in the transposed layout (the config #3 head's
    types) with a bf16 input: bf16 output, flax's numbers to bf16
    rounding."""
    jl = jlocal.LocallyConnected3D(filters=1, kernel_size=3, padding='same',
                                   param_dtype=jnp.bfloat16)
    tl = local.LocallyConnected3D(filters=1, kernel_size=3, padding='same',
                                  input_shape=(4, 5, 6, 2),
                                  param_dtype=torch.bfloat16, device='cpu')
    x = np.asarray(jnp.asarray(_x((1, 4, 5, 6, 2)), jnp.bfloat16))
    params = jax.jit(jl.init)(K0, x)['params']
    assert params['kernel'].dtype == jnp.bfloat16
    convert.load_flax_params(tl, params)
    assert tl.kernel.dtype == torch.bfloat16
    want = np.asarray(jax.jit(jl.apply)({'params': params}, x), np.float32)
    got = tl(torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=2 ** -7, atol=1e-6)


def test_layer_matches_flax_pallas_route(monkeypatch):
    """The JAX layer through its Pallas v2 kernel (interpret mode) against
    the port's layer on the CPU, which takes the plain forms."""
    monkeypatch.setenv('NEURITE_PALLAS_LC', 'interpret')
    jl = jlocal.LocallyConnected3D(filters=2, kernel_size=3, padding='same',
                                   kernel_layout='transposed')
    tl = local.LocallyConnected3D(filters=2, kernel_size=3, padding='same',
                                  input_shape=(4, 8, 8, 3),
                                  kernel_layout='transposed', device='cpu')
    _check_layer(jl, tl, _x((1, 4, 8, 8, 3), 1))


def test_per_tap_form_matches_jax():
    """The keras per-tap form (taken above 1 GB of patches, so not at a
    test's size through the layer) against JAX's `_lc_per_tap`."""
    x = _x((2, 6, 5, 7, 3), 2)
    for ks, st, padding in (((3, 3, 3), (1, 1, 1), 'same'),
                            ((3, 1, 3), (2, 1, 2), 'valid')):
        out = local._lc_out_shape(x.shape[1:4], ks, st, padding)
        k = _x((int(np.prod(out)), int(np.prod(ks)) * 3, 2), 3)
        want, wshape = jlocal._lc_per_tap(jnp.asarray(x), jnp.asarray(k), ks,
                                          st, padding, 2)
        got, gshape = local._lc_per_tap(torch.from_numpy(x),
                                        torch.from_numpy(k), ks, st, padding)
        assert list(gshape) == list(wshape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_keras_and_transposed_layers_agree():
    """A keras layer's kernel through `keras_to_transposed` gives the same
    output in a transposed layer."""
    kw = dict(filters=1, kernel_size=3, padding='same',
              input_shape=(4, 5, 6, 2), device='cpu')
    lk = local.LocallyConnected3D(kernel_layout='keras', **kw)
    lt = local.LocallyConnected3D(kernel_layout='transposed', **kw)
    with torch.no_grad():
        lt.kernel.copy_(lc_tap.keras_to_transposed(lk.kernel))
        lt.bias.copy_(torch.randn(lt.bias.shape))
        lk.bias.copy_(lt.bias)
    x = torch.from_numpy(_x((2, 4, 5, 6, 2), 4))
    torch.testing.assert_close(lt(x), lk(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('layout,filters', [('keras', 1), ('keras', 2),
                                            ('transposed', 1),
                                            ('transposed', 2)])
def test_init_matches_flax_statistics(layout, filters):
    """lecun_normal's fan_in follows the stored shape, as flax computes it:
    1/sqrt(TC*V) in the keras layout, 1/sqrt(TC*O) in the transposed one
    (not the 1/sqrt(TC) the JAX docstring states)."""
    x = jnp.zeros((1, 8, 8, 8, 4))
    jl = jlocal.LocallyConnected3D(filters=filters, kernel_size=3,
                                   padding='same', kernel_layout=layout)
    jk = np.asarray(jax.jit(jl.init)(K0, x)['params']['kernel'])
    tl = local.LocallyConnected3D(filters=filters, kernel_size=3,
                                  padding='same', input_shape=(8, 8, 8, 4),
                                  kernel_layout=layout, device='cpu',
                                  generator=torch.Generator().manual_seed(1))
    tk = tl.kernel.detach().numpy()
    assert tk.shape == jk.shape
    np.testing.assert_allclose(tk.std(), jk.std(), rtol=.05)
    np.testing.assert_allclose(tk.mean(), 0., atol=.05 * jk.std())
    fan_in = 108 * (512 if layout == 'keras' else filters)
    np.testing.assert_allclose(tk.std(), fan_in ** -.5, rtol=.05)
    assert np.abs(tk).max() <= 2 * fan_in ** -.5 / .87962566 + 1e-7
    assert not tl.bias.detach().any()


@pytest.mark.parametrize('name', ['bias', 'linear', 'cross', 'param'])
def test_local_layers_match_flax(name):
    sp, C = (5, 4, 3), 3
    x = _x((2, *sp, C), 5)
    jl, tl = {
        'bias': (jlocal.LocalBias(biasmult=2.),
                 local.LocalBias((*sp, C), biasmult=2., device='cpu')),
        'linear': (jlocal.LocalLinear(),
                   local.LocalLinear((*sp, C), device='cpu')),
        'cross': (jlocal.LocalCrossLinear(output_features=4),
                  local.LocalCrossLinear((*sp, C), 4, device='cpu')),
        'param': (jlocal.LocalParamLayer(shape=(4, 5), mult=3.),
                  local.LocalParamLayer((4, 5), mult=3., device='cpu')),
    }[name]
    if name == 'param':
        params = jax.jit(jl.init)(K0, jnp.asarray(x))['params']
        convert.load_flax_params(tl, params)
        want = np.asarray(jax.jit(jl.apply)({'params': params},
                                            jnp.asarray(x)))
        got = tl(torch.from_numpy(x))
        assert got.shape == (2, 4, 5)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(tl(batch_size=3).detach().numpy()[2],
                                   want[0], rtol=1e-6)
        assert tl().shape == (1, 4, 5)
        return
    _check_layer(jl, tl, x)


@pytest.mark.parametrize('sp', [(6, 5), (5, 4, 6)], ids=['2d', '3d'])
def test_local_cross_linear_trf_matches_flax(sp):
    """Warps through `utils.spatial.batch_transform` (K4 on the card):
    outputs and every gradient, displacements included."""
    C = 2
    jl = jlocal.LocalCrossLinearTrf(output_features=3)
    tl = local.LocalCrossLinearTrf((*sp, C), 3, device='cpu')
    x = _x((2, *sp, C), 6)
    params = jax.jit(jl.init)(K0, jnp.asarray(x))['params']
    # displacements of a few voxels, so that the warps move something
    params = {**params, 'trf': params['trf'] * 1000.}
    convert.load_flax_params(tl, params)

    def apply(p, a):
        return jl.apply({'params': p}, a)

    gy = _x(jax.eval_shape(apply, params, x).shape, 7)
    y, (gp, gx) = _value_and_vjp(apply, (params, jnp.asarray(x)), gy)
    xt = torch.tensor(x, requires_grad=True)
    yt = tl(xt)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    (yt * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)
    got = _leaves(convert.to_flax_params(tl, grad=True))
    for p, w in _leaves(gp).items():
        np.testing.assert_allclose(got[p], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg='/'.join(p))


def test_cpu_layers_launch_nothing():
    """Routing on CPU tensors: every layout takes a plain form."""
    _build.launches.clear()
    for layout in ('auto', 'transposed', 'keras'):
        tl = local.LocallyConnected3D(filters=1, kernel_size=3,
                                      padding='same', input_shape=(4, 4, 4, 2),
                                      kernel_layout=layout, device='cpu')
        x = torch.randn(1, 4, 4, 4, 2, requires_grad=True)
        tl(x).sum().backward()
    m = EncDecLC(16, None, torch.float32, 'cpu')
    m(torch.randn(1, 16, 16, 16, 1), training=True).sum().backward()
    assert sum(_build.launches.values()) == 0


# --- config #3: UNet trunk + LocallyConnected3D head (bench.py:335-372) ----

class JaxEncDecLC(fnn.Module):
    size: int
    dtype: object = None
    param_dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, training=False):
        u = ne.models.unet(nb_features=8, input_shape=(self.size,) * 3 + (1,),
                           nb_levels=3, conv_size=3, nb_labels=4, feat_mult=2,
                           final_pred_activation='linear', dtype=self.dtype,
                           conv_impl='auto', name='trunk')
        return ne.layers.LocallyConnected3D(
            filters=1, kernel_size=3, padding='same',
            param_dtype=self.param_dtype, name='lc')(u(x, training=training))


class EncDecLC(torch.nn.Module):
    """The port's config #3 model; attribute names follow the flax tree
    (`ne.models.unet` drops its name, so flax calls the trunk UNet_0)."""

    def __init__(self, size, dtype, param_dtype, device, lc_impl='auto'):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.UNet_0 = nt.models.unet(
            nb_features=8, input_shape=(size,) * 3 + (1,), nb_levels=3,
            conv_size=3, nb_labels=4, feat_mult=2,
            final_pred_activation='linear', dtype=dtype, conv_impl='auto',
            generator=gen, device=device)
        self.lc = nt.layers.LocallyConnected3D(
            filters=1, kernel_size=3, padding='same',
            input_shape=(size,) * 3 + (4,), param_dtype=param_dtype,
            impl=lc_impl, generator=gen, device=device)

    def forward(self, x, training=None, generator=None):
        return self.lc(self.UNet_0(x, training=training, generator=generator))


def _mse(yt, yp):
    return jnp.mean((yt - yp.astype(jnp.float32)) ** 2)


def _tmse(yt, yp):
    return torch.mean((yt - yp.float()) ** 2)


def _config3_batch(size):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(1, size, size, size, 1)).astype(np.float32),
            rng.normal(size=(1, size, size, size, 1)).astype(np.float32))


def _jax_params(jm, x):
    """The flax tree's shapes and dtypes (no initialization run)."""
    return jax.eval_shape(jm.init, K0, jnp.asarray(x))['params']


def _adam_step(tx, grads, params):
    """The parameters after optax's first step of `tx` from `grads`, as
    one jitted program."""
    def run(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)
    return jax.jit(run)(grads, params)


def _keys(tree, prefix=()):
    out = set()
    for k, v in tree.items():
        out |= (_keys(v, prefix + (k,)) if hasattr(v, 'items')
                else {prefix + (k,)})
    return out


@pytest.fixture(scope='module')
def config3_port():
    """One port step at 16^3 in float32 from the port's own weights: its
    loss, gradients and parameters (before and after Adam), as flax
    trees."""
    x, y = _config3_batch(16)
    tm = EncDecLC(16, None, torch.float32, 'cpu')
    params = convert.to_flax_params(tm)
    state = training.create_train_state(tm, training.adam(1e-4))
    step = training.make_train_step(_tmse)
    state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    return dict(x=x, y=y, params=params, loss=float(m['loss']),
                grads=convert.to_flax_params(tm, grad=True),
                after=convert.to_flax_params(tm))


@pytest.mark.parametrize('route', ['xla', 'pallas_interpret'])
def test_config3_step_matches_jax(config3_port, route, monkeypatch):
    """The port's plain path against the JAX step: through lc_tap (XLA) and
    through the v2 Pallas kernel in interpret mode."""
    if route == 'pallas_interpret':
        monkeypatch.setenv('NEURITE_PALLAS_LC', 'interpret')
    p = config3_port
    jm = JaxEncDecLC(16)
    shapes = _jax_params(jm, p['x'])
    assert _keys(shapes) == _keys(p['params'])
    params = jax.tree.map(jnp.asarray, p['params'])
    lj, gj = jax.jit(jax.value_and_grad(
        lambda q: _mse(p['y'], jm.apply({'params': q}, p['x'],
                                        training=True))))(params)
    np.testing.assert_allclose(p['loss'], float(lj), rtol=1e-5)
    got, want = _leaves(p['grads']), _leaves(gj)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg='/'.join(k))
    # Adam: optax from the port's own gradients (where |g| is near eps,
    # Adam's first step, ~lr*sign(g), is unstable between two gradients
    # that agree to 1e-4), so that the updates compare like with like
    want = _leaves(_adam_step(optax.adam(1e-4), p['grads'], params))
    got = _leaves(p['after'])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg='/'.join(k))


def test_config3_bf16_step_loss_close():
    """bench.py's types (bf16 trunk compute, bf16 head parameters) at 16^3:
    finite losses close to JAX's, from the same weights."""
    x, y = _config3_batch(16)
    tm = EncDecLC(16, torch.bfloat16, torch.bfloat16, 'cpu')
    jm = JaxEncDecLC(16, jnp.bfloat16, jnp.bfloat16)
    shapes = _jax_params(jm, x)
    params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                          convert.to_flax_params(tm), shapes)
    lj = float(jax.jit(lambda q: _mse(y, jm.apply({'params': q}, x,
                                                  training=True)))(params))
    state = training.create_train_state(tm, training.adam(1e-4))
    step = training.make_train_step(_tmse)
    losses = []
    for _ in range(2):
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        losses.append(float(m['loss']))
    assert tm.lc.kernel.dtype == torch.bfloat16
    assert state.optimizer.state[tm.lc.kernel]['exp_avg'].dtype \
        == torch.bfloat16
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], lj, rtol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_step_launches_each_lc_kernel_once(cuda):
    x, y = (torch.from_numpy(a).to(cuda) for a in _config3_batch(16))
    tm = EncDecLC(16, torch.bfloat16, torch.bfloat16, cuda)
    state = training.create_train_state(tm, training.adam(1e-4))
    step = training.make_train_step(_tmse)
    _build.launches.clear()
    for _ in range(2):
        state, m = step(state, (x, y))
    torch.cuda.synchronize()
    assert np.isfinite(float(m['loss']))
    for name in ('lc_fwd', 'lc_dk', 'lc_dx'):
        assert _build.launches[name] == 2, name
    assert _build.launches['pool2_fwd'] == 4
