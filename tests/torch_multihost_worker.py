"""One rank of a parallel run of the PyTorch port (not a pytest module).

    python tests/torch_multihost_worker.py SPEC.json RANK

Started once per rank by ``tests/test_torch_parallel_train.py``,
``tests/test_torch_parallel_spatial.py`` and ``tests/test_torch_cli_ranks.py``
(on the CPU, Gloo) and by
``chip_smoke.py`` (two or four ranks sharing one card, Gloo).  It imports no
JAX, so it runs where JAX is not installed.  The ranks join
``SPEC["store"]`` (a ``file://`` URL) through ``initialize_multihost`` and
run ``SPEC["tasks"]`` in order, each writing its result for this rank under
``SPEC["out"]``.  A task's ``spatial`` (default 1) lays the ranks out as
(world / spatial) x spatial first (``multihost.set_spatial_parallel``); a
rank then takes its data index's rows of a batch and its band of their
image rows.

- ``step``: one ``train_step`` of a model built from ``model`` (keyword
  arguments of ``UrbanPredictor``, ``compute_dtype`` by name) with the
  weights of ``state`` (a saved state_dict) and ``optimizer`` (name, lr,
  weight decay, momentum) on this rank's rows of the global batch in
  ``batch`` (an ``.npz``); writes ``<name>_rank<r>.pt``: the state_dict
  after the step, the metrics, the gradients (summed over every rank and
  divided by the data axis, as the step takes them), the kernel launches
  of that step, the peak of allocated device memory
  (``utils.profiling.device_memory_stats``) and, when
  ``timed`` is given, the times of that many more steps on the same rows
  (taken after the result is kept);
- ``forward``: the model in eval mode on this rank's rows; with ``grad``,
  also the gradient of sum(out^2) over the global batch, each parameter's
  summed over every rank (JAX ``tests/test_train.py``'s spatial recipe);
  without, under ``torch.no_grad``, with the launches of that forward,
  and timed ``timed`` more times; writes ``<name>_rank<r>.pt``: the
  output of this rank's rows, every band gathered (``spatial.gather_rows``),
  the gradients and the times;
- ``epoch``: one ``Trainer`` epoch (``cfg``: ``TrainConfig`` fields) on
  ``data``, recording each train-split index the rank loads, then the
  rank-0 checkpoint restored into a state of another seed and validated
  again; writes ``<name>_rank<r>.json`` (JAX ``tests/multihost_worker.py``
  records the same);
- ``resume``: the flips each rank draws in two epochs run through, and in
  one epoch and a resumed second; writes ``<name>_rank<r>.json``;
- ``cli``: ``cli.main(argv)`` (``maunet-torch train`` on the group this
  worker made), recording each ``Trainer`` it builds (the trial's learning
  rate and weight decay as ``float.hex``, its optimizer) and the history
  each trains; then, with ``direct_work``, a ``Trainer`` built directly with
  the last recorded configuration trains as many epochs; writes
  ``<name>_rank<r>.json``.

The launches each kernel wrapper counted in a task go to
``<name>_rank<r>.launches.json``.  TF32 is off, so a CUDA rank computes in
full f32; ``SPEC["cudnn"]`` false turns cuDNN off (PyTorch's own
convolutions).
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

# Run as a script from anywhere: the repository root holds the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The spatial input channels of every split (data/synthetic.py, data/tiles.py).
IN_CHANNELS = 23


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by name."""
    from maunet_tpu_torch.ops.kernels import lstm, masked_stats, packed_vgg, resize_pack

    return {fn.__name__: fn.launches for fn in (
        packed_vgg.conv3x3_fused, packed_vgg.conv3x3_pair_fused,
        packed_vgg.conv3x3_fused_f32, packed_vgg.conv3x3_pair_fused_f32, lstm.lstm_last_hidden,
        lstm.lstm_forward_stash, lstm.lstm_gate_terms, lstm.lstm_backward, lstm.lstm_dw,
        resize_pack.resize_pack, resize_pack.resize_rows, masked_stats.masked_class_sums)}


def load_model(task: dict, device: torch.device) -> torch.nn.Module:
    """The task's model with the weights of its ``state``, on ``device``."""
    from maunet_tpu_torch.models.factory import UrbanPredictor

    kw = dict(task["model"])
    kw["compute_dtype"] = _DTYPES[kw.get("compute_dtype", "float32")]
    model = UrbanPredictor(**kw)
    model.load_state_dict(torch.load(task["state"], weights_only=True), strict=True)
    return model.to(device)


def load_rows(path: str, device: torch.device) -> tuple[dict[str, torch.Tensor], slice]:
    """This rank's rows of the global batch in ``path``, and its band of
    their image rows under a spatial axis, on ``device``."""
    from maunet_tpu_torch.parallel.multihost import host_batch_slice
    from maunet_tpu_torch.parallel.spatial import shard_rows

    with np.load(path) as z:
        rows = host_batch_slice(len(z["maps"]))
        batch = {k: z[k][rows] for k in z.files}
    for k in ("maps", "targets"):
        batch[k] = np.ascontiguousarray(shard_rows(batch[k]))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}, rows


def peak_bytes(device: torch.device) -> int | None:
    """The peak of allocated memory on ``device`` since the last reset, as
    ``utils.profiling.device_memory_stats`` reads it (None on the CPU)."""
    from maunet_tpu_torch.utils.profiling import device_memory_stats

    for s in device_memory_stats():
        if device.type == "cuda" and s["device"] == str(device):
            return s["peak_bytes_in_use"]
    return None


def _counts_since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in _launch_counts().items()}


def step_task(task: dict, device: torch.device, rank: int, out: str) -> None:
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.train.optimizers import make_optimizer
    from maunet_tpu_torch.train.state import TrainState
    from maunet_tpu_torch.train.steps import train_step

    model = load_model(task, device)
    name, lr, wd, momentum = task["optimizer"]
    state = TrainState(model, make_optimizer(model.parameters(), name, lr, wd, momentum), 0)
    batch, rows = load_rows(task["batch"], device)
    loss_fn, clip = get_loss_fn(task["loss"]), task.get("clip", 0.0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = _launch_counts()
    metrics = train_step(state, batch, loss_fn, gradient_clipping=clip)
    _sync(device)
    result = {"launches": _counts_since(before),
              "state_dict": {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()},
              "metrics": {k: float(v) for k, v in metrics.items()},
              "grads": {n: p.grad.to("cpu", copy=True) for n, p in model.named_parameters()},
              "peak_bytes": peak_bytes(device),
              "rows": [rows.start, rows.stop], "timed_ms": []}
    for _ in range(task.get("timed", 0)):
        _sync(device)
        t0 = time.perf_counter()
        train_step(state, batch, loss_fn, gradient_clipping=clip)
        _sync(device)
        result["timed_ms"].append((time.perf_counter() - t0) * 1e3)
    torch.save(result, os.path.join(out, f"{task['name']}_rank{rank}.pt"))


def forward_task(task: dict, device: torch.device, rank: int, out: str) -> None:
    import torch.distributed as dist

    from maunet_tpu_torch.parallel.spatial import gather_rows, row_shards
    from maunet_tpu_torch.train.steps import model_outputs

    model = load_model(task, device).eval()
    batch, rows = load_rows(task["batch"], device)
    result = {"rows": [rows.start, rows.stop], "grads": {}, "timed_ms": []}
    before = _launch_counts()
    with row_shards(batch["maps"].shape[1]):
        if task.get("grad"):
            named = list(model.named_parameters())
            y = model_outputs(model, batch)
            grads = torch.autograd.grad((y ** 2).sum(), [p for _, p in named],
                                        allow_unused=True)
            for (n, p), g in zip(named, grads):
                # clone: autograd hands one tensor to parameters that share a
                # gradient (the LSTM's two biases), and all_reduce works in place.
                g = torch.zeros_like(p) if g is None else g.clone()
                dist.all_reduce(g)
                result["grads"][n] = g.cpu()
        else:
            with torch.no_grad():
                y = model_outputs(model, batch)
                result["launches"] = _counts_since(before)
                for _ in range(task.get("timed", 0)):
                    _sync(device)
                    t0 = time.perf_counter()
                    model_outputs(model, batch)
                    _sync(device)
                    result["timed_ms"].append((time.perf_counter() - t0) * 1e3)
        result["out"] = gather_rows(y.detach()).cpu()
    torch.save(result, os.path.join(out, f"{task['name']}_rank{rank}.pt"))


class RecordingDataset:
    """The train split, recording every sample index the loader reads."""

    def __init__(self, ds):
        self._ds = ds
        self.seen: list[int] = []

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, idx):
        self.seen.append(int(idx))
        return self._ds[idx]

    def __getattr__(self, name):
        return getattr(self._ds, name)


def epoch_task(task: dict, device: torch.device, rank: int, out: str) -> None:
    from maunet_tpu_torch.train.checkpoint import restore_checkpoint
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(**task["cfg"])
    trainer = Trainer(cfg, task["data"], work_dir=task["work"], study_name="mh",
                      device=device)
    rec = trainer.train_ds = RecordingDataset(trainer.train_ds)
    _sync(device)
    t0 = time.perf_counter()
    result = trainer.train(epochs=1)
    _sync(device)
    seconds = time.perf_counter() - t0

    # Rank 0's checkpoint, restored into a state of another seed, so that a
    # restore that loaded nothing would show, and validated over the ranks.
    trainer.cfg = dataclasses.replace(cfg, seed=cfg.seed + 81)
    fresh = trainer.init_state(IN_CHANNELS)
    trainer.cfg = cfg
    meta = restore_checkpoint(trainer._checkpoint_path("last"), fresh)
    val_restored = trainer.validate(fresh)["total"]
    rows = trainer._host_slice or slice(0, cfg.batch_size)
    with open(os.path.join(out, f"{task['name']}_rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "host_slice": [rows.start, rows.stop],
                   "seen": rec.seen, "best_val_loss": float(result.best_val_loss),
                   "best_checkpoint": result.best_checkpoint,
                   "val_restored": float(val_restored), "restored_step": fresh.step,
                   "restored_epoch": int(meta.get("epoch", -1)),
                   "data_parallel": trainer.data_parallel,
                   "spatial_parallel": trainer.spatial_parallel, "n_train": len(rec),
                   "csv": os.path.exists(trainer.csv.path) if rank == 0 else None,
                   "seconds": seconds}, f)


def resume_task(task: dict, device: torch.device, rank: int, out: str) -> None:
    from maunet_tpu_torch.data.transforms import RandomFlip
    from maunet_tpu_torch.train import loop
    from maunet_tpu_torch.train.config import TrainConfig

    draws: list[list[float]] = []

    class RecordingFlip(RandomFlip):
        def __init__(self, seed):
            super().__init__(seed)
            draws.append([])

        def __call__(self, x, y):
            draws[-1].append(_peek(self.rng))
            return super().__call__(x, y)

    cfg = TrainConfig(**task["cfg"])
    loop.RandomFlip = RecordingFlip
    runs = {}
    for label, plan in (("full", [(2, False)]), ("split", [(1, False), (2, True)])):
        work = os.path.join(task["work"], label)
        for epochs, resume in plan:
            loop.Trainer(cfg, task["data"], work_dir=work, study_name="f",
                         device=device).train(epochs=epochs, resume=resume)
        runs[label] = draws[-len(plan):]
    with open(os.path.join(out, f"{task['name']}_rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, **runs}, f)


def cli_task(task: dict, device: torch.device, rank: int, out: str) -> None:
    from maunet_tpu_torch import cli
    from maunet_tpu_torch.train import loop

    built, histories = [], []
    init, train = loop.Trainer.__init__, loop.Trainer.train

    def recording_init(self, cfg, *args, **kwargs):
        built.append((cfg, kwargs.get("trial_id")))
        init(self, cfg, *args, **kwargs)

    def recording_train(self, *args, **kwargs):
        result = train(self, *args, **kwargs)
        histories.append(result.history)
        return result

    loop.Trainer.__init__, loop.Trainer.train = recording_init, recording_train
    try:
        rc = cli.main(task["argv"])
    finally:
        loop.Trainer.__init__, loop.Trainer.train = init, train
    direct = None
    if task.get("direct_work"):
        cfg = built[-1][0]
        direct = loop.Trainer(cfg, task["data"], work_dir=task["direct_work"],
                              study_name="direct", device=device).train(
                                  epochs=task["epochs"]).history
    with open(os.path.join(out, f"{task['name']}_rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "rc": rc, "histories": histories, "direct": direct,
                   "trainers": [{"trial_id": trial, "learning_rate": cfg.learning_rate.hex(),
                                 "weight_decay": cfg.weight_decay.hex(),
                                 "optimizer": cfg.optimizer} for cfg, trial in built]}, f)


def _peek(rng: np.random.Generator) -> float:
    """The next draw of ``rng``, without moving it."""
    probe = np.random.Generator(type(rng.bit_generator)())
    probe.bit_generator.state = rng.bit_generator.state
    return float(probe.random())


TASKS = {"step": step_task, "forward": forward_task, "epoch": epoch_task,
         "resume": resume_task, "cli": cli_task}


def main() -> None:
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", 1))
    from maunet_tpu_torch.parallel.multihost import initialize_multihost, set_spatial_parallel

    device = initialize_multihost(spec["store"], spec["world"], rank,
                                  backend=spec.get("backend"), device=spec["device"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = spec.get("cudnn", True)
    for task in spec["tasks"]:
        set_spatial_parallel(task.get("spatial", 1))
        before = _launch_counts()
        TASKS[task["kind"]](task, device, rank, spec["out"])
        after = _launch_counts()
        with open(os.path.join(spec["out"], f"{task['name']}_rank{rank}.launches.json"),
                  "w") as f:
            json.dump({k: after[k] - before[k] for k in after}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {rank} of {spec['world']}: {len(spec['tasks'])} task(s) done", flush=True)


if __name__ == "__main__":
    main()
