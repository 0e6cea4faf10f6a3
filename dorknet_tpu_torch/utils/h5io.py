"""Read-side HDF5 checkpoint helpers (counterpart of ``dorknet_tpu/utils/h5io.py``).

The schema is the reference's: ``<layer_name>/layer_info`` carries the type
and hyperparameters as attrs, ``<layer_name>/weights`` (with the regulariser
attrs) and ``<layer_name>/bias`` hold the parameters. Callers pass an open
``h5py.File``; this module does not import h5py itself.
"""

import numpy as np

from dorknet_tpu_torch.regularisers.l2 import l2


def load_regulariser(dset):
    """The regulariser recorded in a weights dataset's attrs, or None."""
    reg_type = dset.attrs.get("weight_regulariser_type", None)
    if reg_type is not None:
        strength = float(dset.attrs["weight_regulariser_strength"])
        if reg_type in (b"l2", "l2"):
            return l2(strength=strength)
    return None


def load_param_datasets(open_f, layer_name, with_bias):
    """-> (weights, bias or None, regulariser) as float32 numpy arrays."""
    dset = open_f[layer_name + "/weights"]
    weights = np.asarray(dset[:], dtype=np.float32)
    bias = (np.asarray(open_f[layer_name + "/bias"][:], dtype=np.float32)
            if with_bias else None)
    return weights, bias, load_regulariser(dset)
