"""
Gloo ranks on the CPU for the port's distributed tests
(`tests/test_torch_parallel.py`, `tests/test_torch_halo.py`).

`launch(suite, world, inputs, workdir)` writes the numpy `inputs` to
`workdir`, starts `world` processes of this file, each a gloo rank of one
process group over a free localhost port, and waits for them. Each rank
runs every case of the suite, in order, on the inputs, and writes what its
cases return; `launch` returns one dict a rank. A rank that fails fails
the launch, with its output. The ranks import torch, numpy and the port,
never JAX: the tests compute the expected values with the JAX package in
their own process, from the same inputs.

    python tests/torch_ranks.py SUITE WORLD RANK PORT WORKDIR
"""

import datetime
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUITES = {'parallel': [], 'halo': []}

# the synthesis knobs of tests/test_torch_synth.py's parity tests: the
# stages whose draws the JAX model does not return are off
SYNTH_KW = dict(noise_max=0, gamma=0, blur_min=1, blur_max=1,
                warp_impl='gather', label_warp_impl='gather', return_vel=True,
                return_def=True, return_aff=True, return_mean=True,
                return_bias=True)
LC_HEAD_LR = 1e-3


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(suite, world, inputs, workdir, timeout=300):
    """Run `suite` on `world` gloo ranks; return each rank's outputs."""
    np.savez(os.path.join(workdir, 'inputs.npz'), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(world),
         str(r), str(port), workdir], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f'rank {r} of {suite} exited {p.returncode}:\n'
                               f'{out[-6000:]}')
    results = []
    for r in range(world):
        with np.load(os.path.join(workdir, f'rank{r}.npz')) as f:
            results.append(dict(f))
    return results


def case(suite):
    def register(fn):
        SUITES[suite].append(fn)
        return fn
    return register


###############################################################################
# helpers of the rank side
###############################################################################

def _np(t):
    return t.detach().float().numpy().copy()


def _state_dict(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def _unflatten(inp, prefix):
    """The nested dict of the inputs named prefix + 'a/b/c'."""
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split('/')
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def _dp_unet(torch, nt):
    return nt.models.unet(nb_features=4, input_shape=(16, 16, 16, 1),
                          nb_levels=2, conv_size=3, nb_labels=2,
                          nb_conv_per_level=1, device='cpu',
                          generator=torch.Generator().manual_seed(0))


def _sgd(torch):
    return lambda params: torch.optim.SGD(params, lr=1e-2)


def _dice_step(nt, **kw):
    return nt.training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss, **kw)


###############################################################################
# the 'parallel' suite (4 ranks)
###############################################################################

def _dp(inp, data, steps):
    import torch
    import neurite_tpu_torch as nt
    from neurite_tpu_torch import parallel
    mesh = parallel.create_mesh(data=data, devices=range(data), device='cpu')
    if mesh.get_coordinate() is None:
        return {}
    calls = []
    base = _dice_step(nt)

    def counting(state, batch, generator=None):
        calls.append(1)
        return base(state, batch, generator)

    state = nt.training.create_train_state(_dp_unet(torch, nt), _sgd(torch))
    run = parallel.make_sharded_train_step(counting, mesh, space_axis=None,
                                           donate_state=False)
    batch = parallel.shard_batch((inp['dp_x'], inp['dp_y']), mesh,
                                 space_axis=None)
    out, losses = {}, []
    for i in range(steps):
        state, m = run(state, batch, torch.Generator().manual_seed(i))
        losses.append(float(m['loss']))
        if i == 0:
            out.update({f'params/{k}': v
                        for k, v in _state_dict(state.model).items()})
    out['losses'] = np.asarray(losses)
    out['calls'] = len(calls)
    out['hooks'] = len(state.optimizer._optimizer_step_pre_hooks)
    out['local_batch'] = batch[0].shape[0]
    return out


@case('parallel')
def dp2(inp):
    """The DP step over 2 ranks of the 4."""
    return _dp(inp, 2, 1)


@case('parallel')
def dp4(inp):
    """The DP step over 4 ranks, 3 calls of one wrapper."""
    return _dp(inp, 4, 3)


@case('parallel')
def robust(inp):
    """robust_multi_gpu in a process group of 4."""
    import torch
    import neurite_tpu_torch as nt
    from neurite_tpu_torch.utils.model import robust_multi_gpu
    wrapped = robust_multi_gpu(_dice_step(nt), verbose=False, device='cpu',
                               space_axis=None, donate_state=False)
    state = nt.training.create_train_state(_dp_unet(torch, nt), _sgd(torch))
    batch = nt.parallel.shard_batch((inp['dp_x'], inp['dp_y']), wrapped.mesh,
                                    space_axis=None)
    _, m = wrapped(state, batch, torch.Generator().manual_seed(1))
    return {'loss': float(m['loss']), 'mesh': np.asarray(wrapped.mesh.shape)}


@case('parallel')
def train_step_axis(inp):
    """make_train_step(axis_name='data') on a 'data' mesh of 4."""
    import torch
    import neurite_tpu_torch as nt
    mesh = nt.parallel.create_mesh(data=4, device='cpu')
    state = nt.training.create_train_state(_dp_unet(torch, nt), _sgd(torch))
    batch = nt.parallel.shard_batch((inp['dp_x'], inp['dp_y']), mesh,
                                    space_axis=None)
    state, m = _dice_step(nt, axis_name='data')(
        state, batch, torch.Generator().manual_seed(1))
    return {'loss': float(m['loss']),
            **{f'params/{k}': v for k, v in _state_dict(state.model).items()}}


@case('parallel')
def multihost(inp):
    """shard_batch_multihost of each rank's share against shard_batch of
    the global batch, on a 2 x 2 mesh."""
    import torch
    from neurite_tpu_torch import parallel
    mesh = parallel.create_mesh(data=2, space=2, device='cpu')
    x = inp['mh_x']
    d = mesh.get_coordinate()[0]
    local = x[d * 4:(d + 1) * 4]
    a = parallel.shard_batch({'x': x}, mesh)['x']
    b = parallel.shard_batch_multihost({'x': local}, mesh)['x']
    return {'block': _np(b), 'equal': bool(torch.equal(a, b))}


@case('parallel')
def multiprocess(inp):
    """tests/test_multiprocess.py's WORKER: 2 ranks each feed their half of
    the global batch through shard_batch_multihost to a DP step of the 2-D
    UNet with JAX's initial weights."""
    import torch
    import neurite_tpu_torch as nt
    from neurite_tpu_torch import parallel
    mesh = parallel.create_mesh(data=2, devices=[0, 1], device='cpu')
    if mesh.get_coordinate() is None:
        return {}
    model = nt.models.unet(nb_features=2, input_shape=(8, 8, 1), nb_levels=2,
                           conv_size=3, nb_labels=2, device='cpu',
                           generator=torch.Generator().manual_seed(0))
    nt.convert.load_flax_params(model, _unflatten(inp, 'mp_params/'))
    state = nt.training.create_train_state(model, _sgd(torch))
    pid = mesh.get_coordinate()[0]
    local = (inp['mp_gx'][pid * 2:(pid + 1) * 2],
             inp['mp_gy'][pid * 2:(pid + 1) * 2])
    step = parallel.make_sharded_train_step(_dice_step(nt), mesh)
    _, m = step(state, parallel.shard_batch_multihost(local, mesh,
                                                      space_axis=None),
                torch.Generator().manual_seed(1))
    return {'loss': float(m['loss'])}


@case('parallel')
def config5(inp):
    """Config #5's DP step at 8^3 over 4 ranks: the synthesis draws made for
    the global batch (JAX's, where JAX returns them), each rank applying
    its slice, then the DP step of the UNet."""
    import torch
    import neurite_tpu_torch as nt
    from neurite_tpu_torch import parallel
    mesh = parallel.create_mesh(data=4, device='cpu')
    labels = inp['c5_labels']
    bs = labels.shape[0]
    gen = nt.models.labels_to_image_new(labels_in=range(4), out_shape=(8,) * 3,
                                        one_hot=True, device='cpu',
                                        **SYNTH_KW)
    draws = gen.perlin(gen.draw(labels.shape,
                                torch.Generator().manual_seed(0)))
    for k in ('aff', 'vel', 'mean', 'bias'):
        draws[k] = torch.from_numpy(inp[f'c5_{k}'])
    i = mesh.get_coordinate()[0]
    per = bs // mesh.size(0)
    mine = {k: v[i * per:(i + 1) * per] if torch.is_tensor(v) and v.ndim
            and v.shape[0] == bs else v for k, v in draws.items()}
    out = gen.apply(torch.from_numpy(labels[i * per:(i + 1) * per]), mine)
    model = nt.models.unet(nb_features=2, input_shape=(8, 8, 8, 1),
                           nb_levels=2, conv_size=3, nb_labels=4,
                           device='cpu',
                           generator=torch.Generator().manual_seed(0))
    state = nt.training.create_train_state(model, nt.training.adam(1e-3))
    step = parallel.make_sharded_train_step(_dice_step(nt), mesh)
    _, m = step(state, (out['image'], out['map']),
                torch.Generator().manual_seed(2))
    return {'loss': float(m['loss'])}


@case('parallel')
def stream(inp):
    """MeanStream and CovStream with axis_name='data' on a 'data' mesh of 4,
    each rank its quarter of the batch."""
    import torch
    import neurite_tpu_torch as nt
    nt.parallel.create_mesh(data=4, device='cpu')
    out = {}
    for name in ('MeanStream', 'CovStream'):
        x = inp[f'stream_{name}']
        r = torch.distributed.get_rank()
        per = x.shape[0] // 4
        layer = getattr(nt.layers, name)(x.shape[1:], cap=10,
                                         axis_name='data', device='cpu')
        y = layer(torch.from_numpy(x[r * per:(r + 1) * per]), training=True)
        out[f'{name}/out'] = _np(y)
        for k, v in layer.named_buffers():
            out[f'{name}/{k}'] = _np(v)
    return out


@case('parallel')
def lc_head(inp):
    """The LC head's step with z-sharded weights on a 2 x 2 mesh: each rank
    holds the kernel's and the bias' z block and their Adam moments; the
    loss is the global batch's mean squared error, the gradients added
    over 'data'."""
    import torch
    from neurite_tpu_torch import parallel
    mesh = parallel.create_mesh(data=2, space=2, device='cpu')
    kernel, bias = inp['lc_kernel'], inp['lc_bias']     # [O, TC, V], [*s, O]
    x, y = inp['lc_x'], inp['lc_y']
    d = x.shape[1]
    shapes = {'kernel': kernel.reshape(*kernel.shape[:2], d, -1),
              'bias': bias}
    shard = parallel.state_shardings_for(
        shapes, mesh, {"['kernel']": (None, None, 'space'),
                       "['bias']": ('space',)})
    params = {k: torch.nn.Parameter(parallel.mesh._local(
        torch.from_numpy(v), mesh, shard[k]).clone())
        for k, v in shapes.items()}
    opt = torch.optim.Adam(params.values(), lr=LC_HEAD_LR, eps=1e-8)
    xb, yb = parallel.shard_batch((x, y), mesh, space_axis=1)
    pred = parallel.sharded_lc(xb, params['kernel'], (3, 3, 3), mesh) \
        + params['bias']
    loss = ((pred - yb) ** 2).sum() / y.size
    loss.backward()
    data = parallel.mesh._axis(mesh, 'data')
    for p in params.values():
        parallel.mesh._all_reduce_(p.grad, data)
    opt.step()
    total = parallel.mesh._all_reduce_(loss.detach().clone(), _world())
    moments = [tuple(opt.state[p]['exp_avg'].shape) for p in params.values()]
    return {'kernel': _np(params['kernel']), 'bias': _np(params['bias']),
            'loss': float(total),
            'moments_match': all(m == tuple(p.shape) for m, p in
                                 zip(moments, params.values())),
            'placements': str(shard['kernel'])}


def _world():
    """The whole process group as a mesh dim."""
    import torch.distributed as dist
    from neurite_tpu_torch.parallel.mesh import _Axis
    return _Axis(dist.group.WORLD, dist.get_world_size(), dist.get_rank(),
                 tuple(range(dist.get_world_size())))


@case('parallel')
def space_raises(inp):
    """make_sharded_train_step with a 'space' dim of 2."""
    import neurite_tpu_torch as nt
    mesh = nt.parallel.create_mesh(data=2, space=2, device='cpu')
    try:
        nt.parallel.make_sharded_train_step(_dice_step(nt), mesh)
    except NotImplementedError as e:
        return {'message': str(e)}
    return {'message': ''}


@case('parallel')
def checkpoint(inp):
    """ModelCheckpointParallel in a group of 4: each rank is given its own
    directory (under the working directory, the launch's); only rank 0
    writes."""
    import torch
    import torch.distributed as dist
    import neurite_tpu_torch as nt
    model = nt.models.unet(nb_features=2, input_shape=(8, 8, 1), nb_levels=2,
                           conv_size=3, nb_labels=2, device='cpu',
                           generator=torch.Generator().manual_seed(0))
    state = nt.training.create_train_state(model, _sgd(torch))
    nt.callbacks.ModelCheckpointParallel(
        f'ckpt_rank{dist.get_rank()}').on_train_end(state)
    dist.barrier()
    return {'written': [os.path.exists(f'ckpt_rank{r}')
                        for r in range(dist.get_world_size())]}


###############################################################################
# the 'halo' suite (4 ranks)
###############################################################################

def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _space(n):
    """A 1 x n 'space' mesh over the first n ranks, or None off it."""
    from neurite_tpu_torch import parallel
    mesh = parallel.create_mesh(data=1, space=n, devices=range(n),
                                device='cpu')
    return mesh if mesh.get_coordinate() is not None else None


def _block(a, mesh, axis=1):
    """This rank's block of axis `axis` of a over the 'space' dim."""
    n, i = mesh.size(1), mesh.get_coordinate()[1]
    size = a.shape[axis] // n
    return np.take(a, range(i * size, (i + 1) * size), axis=axis)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ''


@case('halo')
def halo_modes(inp):
    """halo_exchange of 2 rows in both boundary modes, and its backward."""
    import torch
    from neurite_tpu_torch import parallel
    mesh = _space(4)
    out = {}
    for boundary in ('zero', 'edge'):
        x = _t(_block(inp['halo_x'], mesh)).requires_grad_()
        y = parallel.halo_exchange(x, 2, 1, boundary=boundary)
        (y * _t(_block(inp['halo_g'], mesh))).sum().backward()
        out[f'{boundary}/y'] = _np(y)
        out[f'{boundary}/dx'] = _np(x.grad)
    out['too_wide'] = _raises(lambda: parallel.halo_exchange(
        _t(_block(inp['halo_x'], mesh)), 5, 1))
    return out


@case('halo')
def conv(inp):
    """sharded_conv in 2-D and 3-D, its gradient, and the even kernel."""
    from neurite_tpu_torch import parallel
    mesh = _space(4)
    out = {}
    for nd in (2, 3):
        x = _t(_block(inp[f'conv{nd}_x'], mesh)).requires_grad_()
        k = _t(inp[f'conv{nd}_k']).requires_grad_()
        y = parallel.sharded_conv(x, k, mesh, sharded_axis=1)
        (y * _t(_block(inp[f'conv{nd}_g'], mesh))).sum().backward()
        out.update({f'{nd}d/y': _np(y), f'{nd}d/dx': _np(x.grad),
                    f'{nd}d/dk': _np(k.grad)})
    out['even'] = _raises(lambda: parallel.sharded_conv(
        _t(np.zeros((1, 2, 8, 1), np.float32)),
        _t(np.zeros((4, 3, 1, 1), np.float32)), mesh))
    return out


@case('halo')
def blur_dice(inp):
    """sharded_separable_blur (2-D and 3-D) and sharded_dice_sums."""
    from neurite_tpu_torch import parallel
    mesh = _space(4)
    ks = [inp['blur_k0'], inp['blur_k1']]
    out = {'blur2': _np(parallel.sharded_separable_blur(
        _t(_block(inp['blur_x'], mesh)), ks, mesh)),
        'blur3': _np(parallel.sharded_separable_blur(
            _t(_block(inp['blur3_x'], mesh)), ks + [inp['blur_k1']], mesh))}
    out['too_wide'] = _raises(lambda: parallel.sharded_separable_blur(
        _t(_block(inp['blur_x'], mesh)), [np.ones(11), np.ones(3)], mesh))
    sums = parallel.sharded_dice_sums(_t(_block(inp['dice_x'], mesh)),
                                      _t(_block(inp['dice_y'], mesh)), mesh)
    out.update({f'dice{i}': _np(s) for i, s in enumerate(sums)})
    return out


@case('halo')
def warp(inp):
    """sharded_bounded_warp: 4 shards of [2, 16, 8, 8] (linear and nearest,
    fill 0), and 2 shards of [1, 12, 8, 8, 2] with z shifts up to 3."""
    import torch
    from neurite_tpu_torch import parallel
    from neurite_tpu_torch.utils import spatial
    out = {}
    mesh = _space(4)
    for method in ('linear', 'nearest'):
        out[f'a/{method}'] = _np(parallel.sharded_bounded_warp(
            _t(_block(inp['warp_a_vol'], mesh)),
            _t(_block(inp['warp_a_shift'], mesh)), mesh, max_disp=3.0,
            interp_method=method, fill_value=0.))
    mesh = _space(2)
    if mesh is not None:
        # z shifts on half-integers (nearest's ties) and a halo of 5 (an
        # odd offset of the second block), the unsharded port warp on this
        # rank as the reference: equal, both methods
        vol, shift = inp['warp_a_vol'], inp['warp_tie_shift']
        for method in ('linear', 'nearest'):
            want = spatial.batch_transform(_t(vol), _t(shift),
                                           interp_method=method,
                                           fill_value=0.)
            got = parallel.sharded_bounded_warp(
                _t(_block(vol, mesh)), _t(_block(shift, mesh)), mesh,
                max_disp=4.0, interp_method=method, fill_value=0.)
            out[f'exact/{method}'] = bool(torch.equal(got, _t(_block(
                want.numpy(), mesh))))
        out['b'] = _np(parallel.sharded_bounded_warp(
            _t(_block(inp['warp_b_vol'], mesh)),
            _t(_block(inp['warp_b_shift'], mesh)), mesh, max_disp=4.0,
            fill_value=0.))
    return out


@case('halo')
def lc(inp):
    """sharded_lc's forward, dx and dk, impl 'tap' and 'pallas' (the plain
    forms on the CPU)."""
    from neurite_tpu_torch import parallel
    mesh = _space(4)
    out = {}
    for impl in ('tap', 'pallas'):
        x = _t(_block(inp[f'lc_{impl}_x'], mesh)).requires_grad_()
        k = _t(_block(inp[f'lc_{impl}_k'], mesh, 2)).requires_grad_()
        y = parallel.sharded_lc(x, k, (3, 3, 3), mesh, impl=impl)
        (y * _t(_block(inp[f'lc_{impl}_g'], mesh))).sum().backward()
        out.update({f'{impl}/y': _np(y), f'{impl}/dx': _np(x.grad),
                    f'{impl}/dk': _np(k.grad)})
    return out


def main(suite, world, rank, port, workdir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    os.chdir(workdir)
    with np.load('inputs.npz') as f:
        inp = dict(f)
    out = {}
    for fn in SUITES[suite]:
        for k, v in fn(inp).items():
            out[f'{fn.__name__}.{k}'] = np.asarray(v)
        dist.barrier()
    np.savez(f'rank{rank}.npz', **out)
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
