"""Weights and running statistics made on the device from the seed, in the
reference's names and layouts, and their copy into the program's network.

The benchmark makes the weights; both the program and the plain reference
get them. Every leaf comes from one ``torch.randn`` on the card: He-normal
weights (std sqrt(2 / fan_in)), biases and BN betas 0.1 N(0, 1), BN gammas
1; training cells draw their dense layers' weights at the model's own
0.01 N(0, 1). Running statistics start at mean 0 and std 1 for training (so a
network's first step is a captured one); served networks take them from a
seeded calibration batch through the reference (``plain.Executor`` in mode
"calibrate").
"""

import math

import torch

from benchmark_torch.reference.plain import Executor, fan_in_std


def sub_seed(seed, stream):
    """A seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + int(stream)) % (1 << 62)


def make_params(spec, seed, device, dense_std=None):
    """name -> tensor for every entry of a reference's parameter spec.
    ``dense_std``: the scale of the dense layers' weights in place of
    He-normal (training starts its classifier as the model's own init
    does, 0.01 N(0, 1), so the first loss is near log(classes))."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    noise = torch.randn(total, generator=gen, device=device)
    params, off = {}, 0
    for name, shape, fan_in, kind in spec:
        n = math.prod(shape)
        v = noise[off:off + n].view(shape)
        off += n
        if kind == "weight" or (kind == "dense" and dense_std is None):
            params[name] = v * fan_in_std(fan_in)
        elif kind == "dense":
            params[name] = v * dense_std
        elif kind == "gamma":
            params[name] = torch.ones(shape, device=device)
        else:  # bias, beta
            params[name] = v * 0.1
    return params


def bn_names(spec):
    return [name[:-len("/gamma")] for name, _, _, kind in spec if kind == "gamma"]


def train_stats(spec, params):
    """Running mean 0 and std 1 for every batch norm."""
    return {n: (torch.zeros_like(params[n + "/gamma"]), torch.ones_like(params[n + "/gamma"]))
            for n in bn_names(spec)}


def calibrated_stats(forward, cfg, params, seed, device, images=8):
    """Running stats set layer by layer from a seeded batch of N(0, 1)
    images, through the reference."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    H, W = cfg["image_hw"]
    x = torch.randn((images, 3, H, W), generator=gen, device=device)
    ex = Executor("calibrate", params, {}, generator=gen)
    with torch.no_grad():
        forward(ex, x, cfg)
    return ex.stats


def load_into(net, params, stats):
    """Copy ``params`` and ``stats`` into the program's network, by layer
    name; every parameter of the network must be given, and every given
    one used. Returns {name: the network's parameter tensor}."""
    placed = {}
    with torch.no_grad():
        for module in net.modules():
            layer = getattr(module, "layer_name", None)
            if layer is None:
                continue
            for pname, p in module.named_parameters(recurse=False):
                key = "{}/{}".format(layer, pname)
                src = params[key]
                if src.numel() != p.numel():
                    raise ValueError("{}: the program holds {} values, the reference {}".format(
                        key, p.numel(), src.numel()))
                p.copy_(src.reshape(p.shape))
                placed[key] = p
            if layer in stats and hasattr(module, "running_std"):
                mean, std = stats[layer]
                shape = tuple(module.gamma.shape)
                module.set_state({"running_mean": mean.reshape(shape).cpu().numpy(),
                                  "running_std": std.reshape(shape).cpu().numpy()})
    unused = set(params) - set(placed)
    if unused:
        raise ValueError("parameters the program's network lacks: {}".format(sorted(unused)))
    return placed


def program_stats(net, names):
    """name -> (running mean, running std) of the program's batch norms,
    flat fp32 copies."""
    out = {}
    for module in net.modules():
        layer = getattr(module, "layer_name", None)
        if layer in names:
            out[layer] = (module.running_mean.detach().reshape(-1).float().clone(),
                          module.running_std.detach().reshape(-1).float().clone())
    return out
