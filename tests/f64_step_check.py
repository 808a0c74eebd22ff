"""Why two train-step comparisons of ``tests/test_torch_train_step.py`` miss
in f32: the same steps in both packages, once as they are and once with
every f32 read as f64, on the test's weights, batches and optimizers.

    JAX_PLATFORMS=cpu python tests/f64_step_check.py      # about 1 min

It prints, for the Adam step and for the SGD resume (two JAX steps, exported
and loaded into the port, then step 3 in both):

- in f64, the largest difference of the two packages' step-3 gradients and
  of every parameter and statistic after the steps (relative);
- in f32, the Adam formula check's one element: g, wd * p, g' and the update
  against the formula evaluated in f32 and in f64;
- in f32, each ReLU input (BatchNorm output) of step 3 whose sign the port
  and JAX disagree on, with its value in both and in f64.

f64 here means ``jnp.float32``, ``torch.float32``, ``Tensor.float`` and
``torch.from_numpy`` of f32 arrays all give f64 in the child process
(``--mode 64``); the initial weights are the f32 ones in both modes.
"""

import argparse
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def child(mode: str, out: str, init: str) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    if mode == "64":
        jax.config.update("jax_enable_x64", True)
        jnp.float32 = jnp.float64
        torch.float32 = torch.float64
        torch.Tensor.float = torch.Tensor.double
        torch.set_default_dtype(torch.float64)
        from_numpy = torch.from_numpy
        torch.from_numpy = lambda a: from_numpy(a.astype(np.float64) if a.dtype == np.float32
                                                else a)
        conv = jax.lax.conv_general_dilated
        jax.lax.conv_general_dilated = lambda x, k, *a, **kw: conv(x, k.astype(x.dtype), *a, **kw)
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    import test_torch_train_step as t
    from maunet_tpu.interop.torch_export import _params_to_torch_arrays
    from maunet_tpu_torch.interop.from_jax import state_dict_from_jax
    from maunet_tpu_torch.models import blocks
    from maunet_tpu_torch.train.checkpoint import restore_checkpoint

    dt = np.float64 if mode == "64" else np.float32
    batch = lambda seed: {k: v.astype(dt) if v.dtype == np.float32 else v
                          for k, v in t._batch(seed).items()}
    model = t.JaxUrbanPredictor("unet", compute_dtype=jnp.float32, **t.KW)
    if mode == "32":
        b0 = t._batch(0)
        meta = np.concatenate([b0["metadata"], b0["t1_dates"], b0["t2_dates"]], 1)
        v = jax.jit(model.init)(jax.random.PRNGKey(0), b0["maps"], b0["temp_series"], meta,
                                b0["temp_lengths"])
        with open(init, "wb") as f:
            pickle.dump(t._numpy(v), f)
    with open(init, "rb") as f:
        variables = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x).astype(dt)),
                                           pickle.load(f))
    res = {}

    def port_state(jax_vars, name):
        opt_name, lr, wd, _ = t.OPTIMIZERS[name]
        m = t.UrbanPredictor(compute_dtype=torch.float32, **t.KW)
        if mode == "64":
            m = m.double()
        m.load_state_dict({k: torch.as_tensor(np.asarray(x)) for k, x in
                           state_dict_from_jax(t._numpy(jax_vars)).items()})
        return t.PortState(m, t.make_optimizer(m.parameters(), opt_name, lr, wd, 0.9), 0)

    def keep(prefix, jax_state, port):
        want = state_dict_from_jax(t._numpy(jax_state.variables))
        for k, v in port.model.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                res[f"{prefix}/jax/{k}"] = np.asarray(want[k], np.float64)
                res[f"{prefix}/port/{k}"] = v.numpy().astype(np.float64)

    for name in ("adam", "sgd"):
        opt_name, lr, wd, clip = t.OPTIMIZERS[name]
        tx = t.jax_optimizer(opt_name, lr, wd, 0.9, clip)
        st = t.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
        step = t.make_train_step(model, t.jax_loss_fn(t.LOSS), tx, donate=False)
        if name == "adam":
            ps = port_state(st.variables, name)
            before = {k: p.detach().clone() for k, p in ps.model.named_parameters()}
            st, _ = step(st, batch(0))
            t.train_step(ps, t._torch_batch(batch(0)), t.get_loss_fn(t.LOSS))
            for k, p in ps.model.named_parameters():
                res[f"adam_grad/{k}"] = p.grad.numpy().astype(np.float64)
                res[f"adam_p0/{k}"] = before[k].numpy().astype(np.float64)
            keep("adam", st, ps)
            continue
        for seed in (0, 1):
            st, _ = step(st, batch(seed))
        path = os.path.join(os.path.dirname(out), f"jax_{mode}.pth")
        t.export_torch_checkpoint(path, t._numpy(st.variables),
                                  {"model_type": "unet", "optimizer": opt_name, "learning_rate": lr,
                                   "weight_decay": wd, "momentum": 0.9},
                                  opt_state=st.opt_state, step=2, epoch=0)
        ps = port_state(st.variables, name)
        restore_checkpoint(path, ps)
        relu = {}
        bn_train = blocks.batch_norm_train
        names = {id(m): n for n, m in ps.model.named_modules()}

        def recorded(y, bn):
            out = bn_train(y, bn)
            relu[names[id(bn)]] = out.detach().numpy().astype(np.float64)
            return out

        blocks.batch_norm_train = recorded
        b2 = batch(2)
        jax_relu = t._jax_relu_inputs(model, st, b2)
        grads = _params_to_torch_arrays(t._numpy(t._jax_grads(model, st, b2)))
        st3, _ = step(st, b2)
        t.train_step(ps, t._torch_batch(b2), t.get_loss_fn(t.LOSS), gradient_clipping=clip)
        blocks.batch_norm_train = bn_train
        for k, p in ps.model.named_parameters():
            res[f"grad/port/{k}"] = p.grad.numpy().astype(np.float64)
            res[f"grad/jax/{k}"] = np.asarray(grads[k], np.float64)
        for k, v in relu.items():
            res[f"relu/port/{k}"] = v
            res[f"relu/jax/{k}"] = np.asarray(jax_relu[k], np.float64)
        keep("sgd", st3, ps)
    np.savez(out, **res)


def report(d: str) -> None:
    a32, a64 = np.load(os.path.join(d, "32.npz")), np.load(os.path.join(d, "64.npz"))
    keys = lambda pre: sorted(k[len(pre):] for k in a64.files if k.startswith(pre))
    for name in ("adam", "sgd"):
        ks = keys(f"{name}/jax/")
        rel = max(float(np.max(np.abs(a64[f"{name}/port/{k}"] - a64[f"{name}/jax/{k}"])
                               / np.maximum(np.abs(a64[f"{name}/jax/{k}"]), 1e-30))) for k in ks)
        print(f"f64, {name}: every parameter and statistic after the steps within {rel:.2e} "
              f"relative, port against JAX")
    g = max(float(np.abs(a64[f"grad/port/{k}"] - a64[f"grad/jax/{k}"]).max())
            for k in keys("grad/jax/"))
    print(f"f64, sgd step 3: gradients within {g:.2e}, port against JAX")

    lr, wd = 1e-3, 1e-3     # the test's Adam (OPTIMIZERS["adam"])
    for k in keys("adam_grad/"):
        g32, p0 = a32[f"adam_grad/{k}"].astype(np.float32), a32[f"adam_p0/{k}"].astype(np.float32)
        delta = a32[f"adam/port/{k}"] - p0.astype(np.float64)
        gk32 = g32 + np.float32(wd) * p0
        want32 = (-lr * gk32 / (np.abs(gk32) + 1e-8)).astype(np.float64)
        gk64 = g32.astype(np.float64) + wd * p0.astype(np.float64)
        want64 = -lr * gk64 / (np.abs(gk64) + 1e-8)
        ulp2 = 2 * float(np.spacing(np.float32(np.abs(p0).max())))
        for i in np.argwhere(np.abs(delta - want32) > ulp2 + 1e-4 * np.abs(want32)):
            i = tuple(i)
            print(f"f32, adam formula check misses {k}{[int(x) for x in i]}: g {g32[i]:.6e}, wd*p "
                  f"{float(wd * p0[i]):.6e}, g' {gk64[i]:.4e}; update {delta[i]:.6e}, formula in f32 "
                  f"{want32[i]:.6e}, in f64 {want64[i]:.6e}")
    for k in keys("relu/jax/"):
        port, jax_, exact = a32[f"relu/port/{k}"], a32[f"relu/jax/{k}"], a64[f"relu/jax/{k}"]
        for i in np.argwhere((port > 0) != (jax_ > 0)):
            i = tuple(i)
            print(f"f32, sgd step 3: ReLU input {k}{[int(x) for x in i]} is {port[i]:+.3e} in the port, "
                  f"{jax_[i]:+.3e} in JAX, {exact[i]:+.3e} in f64")
    worst = max(keys("grad/jax/"), key=lambda k: np.abs(a32[f"grad/port/{k}"]
                                                       - a64[f"grad/jax/{k}"]).max())
    print(f"f32, sgd step 3: the port's gradient is furthest from f64 at {worst}, by "
          f"{np.abs(a32[f'grad/port/{worst}'] - a64[f'grad/jax/{worst}']).max():.2e} "
          f"(JAX's f32 by {np.abs(a32[f'grad/jax/{worst}'] - a64[f'grad/jax/{worst}']).max():.2e})")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["32", "64"])
    p.add_argument("--out")
    p.add_argument("--init")
    args = p.parse_args()
    if args.mode:
        child(args.mode, args.out, args.init)
        return
    with tempfile.TemporaryDirectory() as d:
        init = os.path.join(d, "init.pkl")
        for mode in ("32", "64"):
            subprocess.run([sys.executable, __file__, "--mode", mode, "--init", init,
                            "--out", os.path.join(d, f"{mode}.npz")], check=True,
                           stderr=subprocess.DEVNULL)
        report(d)


if __name__ == "__main__":
    main()
