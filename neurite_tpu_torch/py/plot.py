"""
Host-side plotting utilities (matplotlib), a copy of
`neurite_tpu/py/plot.py` (numpy and matplotlib only; every matplotlib
import is inside a function, so importing this module needs none).

Capability parity with reference `neurite/py/plot.py` (`slices:31-141`,
`volume3D:144-179`, `flow_legend:182-206`, `flow:209-327`, `pca:330-368`),
rewritten around a shared grid-figure helper.
"""

import numpy as np


def _conform_list(inputs, n, name, default=None):
    """Broadcast None/single-element inputs to a length-n list."""
    if inputs is None:
        inputs = [default]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if len(inputs) not in (1, n):
        raise ValueError(f'number of {name} is incorrect')
    if len(inputs) == 1:
        inputs = list(inputs) * n
    return list(inputs)


def _grid_dims(nb_plots, grid):
    if not grid:
        return 1, nb_plots
    if isinstance(grid, bool):
        rows = int(np.floor(np.sqrt(nb_plots)))
        cols = int(np.ceil(nb_plots / rows))
        return rows, cols
    if not isinstance(grid, (list, tuple)):
        raise ValueError('grid should either be bool or [rows, cols]')
    return grid


def _subplot_grid(rows, cols):
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(rows, cols, squeeze=False)
    return fig, axs


def slices(slices_in, titles=None, cmaps=None, norms=None, do_colorbars=False,
           grid=False, width=15, show=True, axes_off=True, plot_block=True,
           facecolor=None, imshow_args=None):
    """
    Plot a row or grid of 2D slices (or RGB images).

    Parity: reference `neurite/py/plot.py:31-141`.
    Returns (fig, axs).
    """
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    if isinstance(slices_in, np.ndarray):
        slices_in = [slices_in]
    slices_in = [np.squeeze(np.asarray(s)) for s in slices_in]
    nb_plots = len(slices_in)
    for s in slices_in:
        if not (s.ndim == 2 or (s.ndim == 3 and s.shape[-1] == 3)):
            raise ValueError('each slice has to be 2d or RGB (3 channels)')

    titles = _conform_list(titles, nb_plots, 'titles')
    cmaps = _conform_list(cmaps, nb_plots, 'cmaps', default='gray')
    norms = _conform_list(norms, nb_plots, 'norms')
    imshow_args = [a or {} for a in
                   _conform_list(imshow_args, nb_plots, 'imshow_args')]

    rows, cols = _grid_dims(nb_plots, grid)
    fig, axs = _subplot_grid(rows, cols)

    for i in range(rows * cols):
        ax = axs[i // cols][i % cols]
        if axes_off:
            ax.axis('off')
        if i >= nb_plots:
            continue
        if titles[i] is not None:
            ax.title.set_text(titles[i])
        im_ax = ax.imshow(slices_in[i], cmap=cmaps[i],
                          interpolation='nearest', norm=norms[i],
                          **imshow_args[i])
        if do_colorbars:
            divider = make_axes_locatable(ax)
            cax = divider.append_axes('right', size='5%', pad=0.05)
            fig.colorbar(im_ax, cax=cax)

    fig.set_size_inches(width, rows / cols * width)
    if facecolor is not None:
        fig.set_facecolor(facecolor)
    if show:
        plt.tight_layout()
        plt.show(block=plot_block)
    return fig, axs


def volume3D(vols, slice_nos=None, data_squeeze=True, **kwargs):
    """
    Plot the three mid-slices (or given slice numbers) of 3D volume(s).

    Parity: reference `neurite/py/plot.py:144-179`.
    """
    if not isinstance(vols, (tuple, list)):
        vols = [vols]
    nb_vols = len(vols)
    vols = [np.squeeze(v) if data_squeeze else np.asarray(v) for v in vols]
    if not all(v.ndim == 3 for v in vols):
        raise ValueError('only 3d volumes allowed in volume3D')

    slics = []
    for vi, vol in enumerate(vols):
        if slice_nos is None:
            nos = [f // 2 for f in vol.shape]
        elif isinstance(slice_nos[0], (list, tuple)):
            nos = slice_nos[vi]
        else:
            nos = slice_nos
        slics += [np.take(vol, nos[d], d) for d in range(3)]

    kwargs.setdefault('titles', [f'axis {d}' for d in range(3)] * nb_vols)
    kwargs.setdefault('grid', [nb_vols, 3])
    return slices(slics, **kwargs)


def flow_legend(plot_block=True):
    """Quiver legend showing the angle-color mapping of flow() (ref :182-206)."""
    import matplotlib.pyplot as plt
    import matplotlib.cm as cm
    from matplotlib.colors import Normalize

    ph = np.linspace(0, 2 * np.pi, 13)
    x, y = np.cos(ph), np.sin(ph)
    colors = np.arctan2(x, y)
    norm = Normalize()
    norm.autoscale(colors)

    plt.figure(figsize=(6, 6))
    plt.xlim(-2, 2)
    plt.ylim(-2, 2)
    plt.quiver(x, y, x, y, color=cm.winter(norm(colors)), angles='xy',
               scale_units='xy', scale=1)
    plt.show(block=plot_block)


def flow(slices_in, titles=None, cmaps=None, width=15, indexing='ij',
         img_indexing=True, grid=False, show=True, quiver_width=None,
         plot_block=True, scale=1):
    """
    Plot a row or grid of 2D flow fields as angle-colored quiver plots.

    Parity: reference `neurite/py/plot.py:209-327`.
    """
    import matplotlib.pyplot as plt
    import matplotlib.cm as cm
    from matplotlib.colors import Normalize

    nb_plots = len(slices_in)
    for s in slices_in:
        if not (s.ndim == 3 and s.shape[-1] == 2):
            raise ValueError('each slice has to be 3d: 2d+2 channels')
    if indexing not in ('ij', 'xy'):
        raise ValueError(f"indexing must be 'ij' or 'xy', got {indexing!r}")

    slices_in = [np.array(s, copy=True) for s in slices_in]
    if indexing == 'ij':
        for s in slices_in:
            s[:, :, 1] = -s[:, :, 1]  # y-axis points down in image view
    if img_indexing:
        slices_in = [np.flipud(s) for s in slices_in]

    titles = _conform_list(titles, nb_plots, 'titles')
    cmaps = _conform_list(cmaps, nb_plots, 'cmaps')
    scale = _conform_list(scale, nb_plots, 'scale')

    rows, cols = _grid_dims(nb_plots, grid)
    fig, axs = _subplot_grid(rows, cols)

    for i in range(rows * cols):
        ax = axs[i // cols][i % cols]
        ax.axis('off')
        if i >= nb_plots:
            continue
        if titles[i] is not None:
            ax.title.set_text(titles[i])
        u, v = slices_in[i][..., 0], slices_in[i][..., 1]
        colors = np.arctan2(u, v)
        colors[np.isnan(colors)] = 0
        norm = Normalize()
        norm.autoscale(colors)
        if cmaps[i] is not None:
            raise Exception('custom cmaps not currently implemented for flow()')
        ax.quiver(u, v, color=cm.winter(norm(colors).flatten()),
                  angles='xy', units='xy', width=quiver_width,
                  scale=scale[i])
        ax.axis('equal')

    fig.set_size_inches(width, rows / cols * width)
    plt.tight_layout()
    if show:
        plt.show(block=plot_block)
    return fig, axs


def pca(pca_obj, x, y, plot_block=True):
    """
    PCA diagnostics figure: explained variance, reconstruction error,
    component orthogonality.

    Parity: reference `neurite/py/plot.py:330-368`.
    """
    import matplotlib.pyplot as plt

    x_mean = np.mean(x, 0)
    x_std = np.std(x, 0)
    W = pca_obj.components_
    y_hat = x @ W + pca_obj.mean_
    y_err = y_hat - y
    y_rel_err = y_err / np.maximum(0.5 * (np.abs(y) + np.abs(y_hat)),
                                   np.finfo('float').eps)

    plt.figure(figsize=(15, 7))
    plt.subplot(2, 3, 1)
    plt.plot(pca_obj.explained_variance_ratio_)
    plt.title('var % explained')
    plt.subplot(2, 3, 2)
    plt.plot(np.cumsum(pca_obj.explained_variance_ratio_))
    plt.ylim([0, 1.01])
    plt.grid()
    plt.title('cumvar explained')
    plt.subplot(2, 3, 3)
    plt.plot(np.cumsum(pca_obj.explained_variance_ratio_))
    plt.ylim([0.8, 1.01])
    plt.grid()
    plt.title('cumvar explained')
    plt.subplot(2, 3, 4)
    plt.plot(x_mean)
    plt.plot(x_mean + x_std, 'k')
    plt.plot(x_mean - x_std, 'k')
    plt.title('x mean across dims (sorted)')
    plt.subplot(2, 3, 5)
    plt.hist(y_rel_err.flat, 100)
    plt.title('y rel err histogram')
    plt.subplot(2, 3, 6)
    plt.imshow(W @ W.T, cmap=plt.get_cmap('gray'))
    plt.colorbar()
    plt.title("W * W'")
    plt.show(block=plot_block)
