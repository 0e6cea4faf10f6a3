"""Single layer-type registry for checkpoint reconstruction (counterpart of
``dorknet_tpu/layers/registry.py``): each layer class registers itself under
its h5 type name, and the network loader and composite layers look types up
in the same table."""

LAYER_REGISTRY = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def get_layer_class(type_name):
    try:
        return LAYER_REGISTRY[type_name]
    except KeyError:
        raise KeyError(
            "Unknown layer type {!r} in checkpoint (registered: {})".format(
                type_name, sorted(LAYER_REGISTRY))) from None
