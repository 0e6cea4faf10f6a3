"""HDF5 checkpoint helpers (counterpart of ``dorknet_tpu/utils/h5io.py``),
both sides, in the reference's byte format.

Schema per layer: ``<layer_name>/layer_info`` is a scalar float32 dataset
whose attrs carry the type name and hyperparameters,
``<layer_name>/weights`` (with the regulariser attrs, written as
``np.bytes_``) and ``<layer_name>/bias`` hold the parameters, and
``<layer_name>/grads/...`` the gradients beside them. Batch norm stores
gamma, beta, running_mean and running_std instead; a residual block
recurses into its children. Callers pass an open ``h5py.File``; this module
does not import h5py itself.
"""

import numpy as np

from dorknet_tpu_torch.regularisers.l2 import l2


def to_np(x):
    """A host numpy array of a tensor (on any device) or an array."""
    if hasattr(x, "detach"):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def create_layer_info(open_f, layer_name, type_name, **attrs):
    base = open_f.create_dataset(layer_name + "/layer_info", dtype=np.float32)
    base.attrs["type"] = type_name
    for k, v in attrs.items():
        base.attrs[k] = v
    return base


def save_array(open_f, path, arr):
    arr = to_np(arr)
    dset = open_f.create_dataset(path, arr.shape, dtype=arr.dtype)
    if arr.shape == ():
        dset[()] = arr
    else:
        dset[:] = arr
    return dset


def attach_regulariser_attrs(dset, regulariser):
    if regulariser is not None:
        # the reference wrote np.string_(...), byte strings: keep that format
        dset.attrs["weight_regulariser_type"] = np.bytes_(regulariser.type)
        dset.attrs["weight_regulariser_strength"] = np.bytes_(str(regulariser.strength))


def save_param_datasets(open_f, layer_name, learned_params, grads,
                        weight_regulariser, with_bias, save_grads=True):
    """The weights/bias/grads block shared by the conv, depthwise,
    pointwise and dense layers."""
    dset = save_array(open_f, layer_name + "/weights", learned_params["weights"])
    attach_regulariser_attrs(dset, weight_regulariser)
    if with_bias:
        save_array(open_f, layer_name + "/bias", learned_params["bias"])
    if save_grads:
        save_array(open_f, layer_name + "/grads/weights", grads["weights"])
        if with_bias:
            save_array(open_f, layer_name + "/grads/bias", grads["bias"])


def load_regulariser(dset):
    """The regulariser recorded in a weights dataset's attrs, or None."""
    reg_type = dset.attrs.get("weight_regulariser_type", None)
    if reg_type is not None:
        strength = float(dset.attrs["weight_regulariser_strength"])
        if reg_type in (b"l2", "l2"):
            return l2(strength=strength)
    return None


def read_array(open_f, path):
    """The dataset at ``path`` as a float32 numpy array."""
    return np.asarray(open_f[path][:], dtype=np.float32)


def load_param_datasets(open_f, layer_name, with_bias, load_grads=True):
    """-> (weights, bias or None, regulariser, grads) as float32 numpy
    arrays; grads holds ``grads/weights`` (and ``grads/bias``) when
    ``load_grads``, else it is empty. As in the JAX loader, a file without
    them raises KeyError when ``load_grads`` is set."""
    dset = open_f[layer_name + "/weights"]
    weights = np.asarray(dset[:], dtype=np.float32)
    bias = read_array(open_f, layer_name + "/bias") if with_bias else None
    grads = {}
    if load_grads:
        grads["weights"] = read_array(open_f, layer_name + "/grads/weights")
        if with_bias:
            grads["bias"] = read_array(open_f, layer_name + "/grads/bias")
    return weights, bias, load_regulariser(dset), grads
