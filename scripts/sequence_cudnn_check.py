#!/usr/bin/env python3
"""The sequence line's LSTM steps on the card with and without cuDNN.

Runs ``chip_smoke.sequence_phase`` with its checks reported rather than
fatal (its JSON line, then each failed check), then takes the gradients of
five step kinds (``lstm.step``, ``lstm-nll.step``, ``lstm-gat.step``,
``lstm-gat.finetune``, ``seq2seq-graph.step``) from the phase's trained
weights on the card three ways (cuDNN on, cuDNN deterministic, cuDNN off
for the whole call) and on the CPU in float32, each against float64 on the
CPU with the same batches, draws and kNN graphs: one JSON line each with
the loss, the gradient norm and direction, and each parameter's gradient,
relative. ``models.seq.LSTMLayer`` switches cuDNN off for its own calls;
the ``cudnn`` rows lift that switch, and so does a last line with the
phase's update rates and fine-tune census under cuDNN, to set beside the
phase's own (the same host, the same call). Needs one CUDA device.

    python3 scripts/sequence_cudnn_check.py
"""

import contextlib
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from molecular_dynamics_tpu_torch.models import seq as mseq  # noqa: E402

STEPS = ("lstm.step", "lstm-nll.step", "lstm-gat.step", "lstm-gat.finetune", "seq2seq-graph.step")


def main() -> int:
    print("tf32", torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
          os.environ.get("NVIDIA_TF32_OVERRIDE"), torch.backends.cudnn.version(), flush=True)
    fails = []
    cs.check = lambda cond, msg: None if cond else fails.append(msg)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        res, launches = cs.sequence_phase(tmp, dev)
        cs.emit("sequence", **res, seconds=round(time.perf_counter() - t0, 1),
                device=torch.cuda.get_device_name(0), nvidia_smi=cs.nvidia_smi_line())
        for f in fails:
            print("CHECK FAILS:", f[:400], flush=True)
        data = cs.sequence_data(str(cs.TRAIN_DATA / "raw-traj_rep-*.npy"))
        graphs = {}

        def grads(device, dtype):
            out = {}
            for name, module, loss_fn, _ in cs.sequence_steps(
                    cs.sequence_models(tmp / "sequence", device, dtype), data, device, dtype):
                if name in STEPS:
                    with cs.graphs_of(graphs.setdefault(name, [])):
                        loss = loss_fn()
                    g = torch.autograd.grad(loss, list(module.parameters()), materialize_grads=True)
                    out[name] = (float(loss.detach()), [x.double().cpu() for x in g],
                                 [n for n, _ in module.named_parameters()])
            return out

        ref = grads(cpu, torch.float64)
        sides = {"cpu_f32": grads(cpu, torch.float32), "no_cudnn": grads(dev, torch.float32)}
        with cs.patched(((mseq, "_without_cudnn", contextlib.nullcontext),)):
            sides["cudnn"] = grads(dev, torch.float32)
            torch.backends.cudnn.deterministic = True
            sides["cudnn_deterministic"] = grads(dev, torch.float32)
            torch.backends.cudnn.deterministic = False
            runs = tmp / "sequence"
            cudnn = {"update_rates_40": cs.update_rates_of(cs.sequence_steps(
                cs.sequence_models(runs, dev, torch.float32), data, dev, torch.float32)),
                     **cs.sequence_census(runs, data, dev)}
    for name in STEPS:
        l64, g64, names = ref[name]
        f64 = torch.cat([g.reshape(-1) for g in g64])
        for side, out in sides.items():
            loss, g, _ = out[name]
            f = torch.cat([x.reshape(-1) for x in g])
            print(json.dumps({
                "step": name, "side": side, "loss": abs(loss - l64) / abs(l64),
                "norm": float(abs(f.norm() - f64.norm()) / f64.norm()),
                "dir": float((f / f.norm() - f64 / f64.norm()).norm()),
                "by_param": {n: float((a - b).norm() / b.norm()) for n, a, b in zip(names, g, g64)},
            }), flush=True)
    print(json.dumps({"with_cudnn": cudnn}), flush=True)
    print(json.dumps({"fails": len(fails), "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
