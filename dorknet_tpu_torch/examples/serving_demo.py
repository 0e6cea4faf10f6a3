"""Self-contained serving-stack demo, no dataset needed (the twin of
``examples/serving_demo.py``).

Trains a small convnet on a synthetic colour task (with an EMA of the
weights kept by the trainer), then walks the serving ladder and reports the
latency and top-1 agreement of each rung:

  1. plain test-mode forward              (the reference's serving story)
  2. InferenceRunner                      (fixed-shape batches)
  3. InferenceRunner(fold_bn=True)        (conv<-BN folding)
  4. int8 serving                         (skipped: A7 of ROADMAP.md brings it)
  5. ...serving the EMA weights           (trainer.ema_network())
  6. BatchingServer                       (dynamic batching front end)
  7. export_program / load_serving_program (the serving artifact)
  8. a polymorphic-batch artifact         (load_serving_artifact)

Unlike the JAX demo's network, this one has a depthwise-separable stage, so
every rung from 2 on (the reloaded artifacts included) runs the hand-written
depthwise kernel on the card.

Run:  python -m dorknet_tpu_torch.examples.serving_demo [--device cpu]

Latencies are host-clock times of ``predict_probs``, which returns numpy
(so the card has finished), best of five after one warm-up.
"""

import argparse
import tempfile
import time

import numpy as np

from dorknet_tpu_torch.layers import (BatchNormLayer, ConvLayer, DenseLayer,
                                      DepthwiseConvLayer, GlobalAveragePoolingLayer,
                                      PointwiseConvLayer, ReLu, SoftmaxWithCrossEntropy)
from dorknet_tpu_torch.network import (BatchingServer, FeedForwardNetwork, InferenceRunner,
                                       Trainer, load_serving_artifact, load_serving_program)
from dorknet_tpu_torch.optimisers import SGDMomentum


def make_batch(rng, B=64, size=32, classes=4):
    y = rng.randint(0, classes, B)
    X = rng.randn(B, 3, size, size).astype(np.float32) * 10.0
    X += 30.0 * y[:, None, None, None]  # channel-intensity signal
    return X, np.eye(classes, dtype=np.float32)[y], y


def build_net(classes=4):
    net = FeedForwardNetwork("serving-demo")
    net.add_layer(ConvLayer("c1", filter_block_shape=(16, 3, 3, 3), with_bias=False,
                            weight_initialiser="glorot_uniform"))
    net.add_layer(BatchNormLayer("b1", incoming_chans=16))
    net.add_layer(ReLu("r1"))
    net.add_layer(DepthwiseConvLayer("dw2", filter_block_shape=(16, 3, 3), stride=2,
                                     with_bias=False))
    net.add_layer(BatchNormLayer("dw2_bn", incoming_chans=16))
    net.add_layer(ReLu("dw2_r"))
    net.add_layer(PointwiseConvLayer("pw2", filter_block_shape=(32, 16), with_bias=False,
                                     weight_initialiser="glorot_uniform"))
    net.add_layer(BatchNormLayer("b2", incoming_chans=32))
    net.add_layer(ReLu("r2"))
    net.add_layer(GlobalAveragePoolingLayer("gap"))
    net.add_layer(DenseLayer("d1", incoming_chans=32, output_dim=classes,
                             weight_initialiser="glorot_uniform"))
    net.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))
    return net


def time_server(tag, predict, X, ref_top1=None, trials=5):
    probs = predict(X)  # warm-up (the first call on the card builds the kernels)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        probs = predict(X)
        best = min(best, time.perf_counter() - t0)
    top1 = np.asarray(probs).argmax(axis=1)
    agree = "" if ref_top1 is None else \
        "  top-1 agreement {:.3f}".format((top1 == ref_top1).mean())
    print("{:38s} {:7.2f} ms/batch{}".format(tag, best * 1e3, agree))
    return top1


def main(steps=60, device="cuda", batch=64, size=32):
    rng = np.random.RandomState(0)
    np.random.seed(0)
    net = build_net()
    # ema_decay scales with run length: the shadow keeps decay^steps of the
    # initial weights, so a 60-step demo wants 0.9 (0.9^60 ~ 0.2%)
    trainer = Trainer(net, SGDMomentum(net, 0.05, 0.9), ema_decay=0.9, device=device)
    for _ in range(steps):
        X, oh, _ = make_batch(rng, B=batch, size=size)
        loss, _ = trainer.step(X, oh)
    print("trained {} steps on {}, final loss {:.3f}\n".format(steps, device, float(loss)))

    X_eval, _, y_eval = make_batch(rng, B=batch, size=size)
    print("batch={} serving ladder (best-of-5, host clock):".format(batch))
    ref = time_server("net.forward(test_mode=True)",
                      lambda X: net.forward(X, test_mode=True)[1].cpu().numpy(), X_eval)
    print("  eval accuracy: {:.3f}".format((ref == y_eval).mean()))

    r = InferenceRunner(net, batch_size=batch, device=device)
    time_server("InferenceRunner", r.predict_probs, X_eval, ref)

    rf = InferenceRunner(net, batch_size=batch, device=device, fold_bn=True)
    time_server("InferenceRunner(fold_bn)", rf.predict_probs, X_eval, ref)

    print("{:38s} skipped: QuantizedInferenceRunner comes with A7".format("int8 serving"))

    re = InferenceRunner(trainer.ema_network(), batch_size=batch, device=device,
                         fold_bn=True)
    ema_top1 = time_server("EMA weights + fold_bn", re.predict_probs, X_eval, ref)
    print("  EMA eval accuracy: {:.3f}".format((ema_top1 == y_eval).mean()))

    # 6) the deployment front end: concurrent single-image callers coalesced
    # into the runner's one batch shape
    with BatchingServer(rf, max_wait_ms=100) as srv:
        futs = [srv.submit(X_eval[i]) for i in range(batch)]
        batched = np.stack([f.result(timeout=60) for f in futs])
        print("BatchingServer: {} concurrent singles -> {} device dispatch(es); top-1 "
              "agreement with plain forward: {:.3f}".format(
                  batch, srv.dispatches, (batched.argmax(1) == ref).mean()))

    # 7) the deployment artifact: the serving program with the weights in it,
    # reloaded without the model code
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/demo.pt2"
        blob = rf.export_program(X_eval.shape[2:], path=path)
        served = load_serving_program(path)
        exported = served(X_eval).cpu().numpy()
        print("export_program: {} KB artifact; reloaded top-1 agreement with the runner "
              "it serialised: {:.3f}".format(
                  len(blob) // 1024, (exported.argmax(1) == rf.predict(X_eval)).mean()))

    # 8) a polymorphic-batch artifact: one file serves every batch size
    art = load_serving_artifact(rf.export_program(X_eval.shape[2:], polymorphic_batch=True))
    sizes = [1, 7, batch]
    agree = [(art.predict(X_eval[:n]) == rf.predict(X_eval[:n])).mean() for n in sizes]
    print("polymorphic artifact: batches {} -> top-1 agreement {}".format(
        sizes, [round(float(a), 3) for a in agree]))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    main(steps=args.steps, device=args.device)
