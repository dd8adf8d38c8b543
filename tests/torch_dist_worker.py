"""One process of a multi-process training-step run on the CPU (gloo).

    python tests/torch_dist_worker.py <coordinator> <nproc> <rank> <case.pt>
        <out.pt>

``case.pt`` (``torch.save`` of a dict, written by the test that starts
the processes) holds the model config, a JAX ``TrainState`` as numpy
(``jstate``, crossed by ``train_state_from_jax``), the optimizer and step
keywords, the global batch and the step count. Each process takes its rows
of the global batch (``local_batch_slice``) and the steps; then writes, per
step, the metrics and its state in the port's keys to ``out.pt.<rank>``.
Imports torch and the port only (no JAX), as a worker of the port would.
"""

import sys

import torch


def snapshot(st):
    from desenet_tpu_torch.train.state import bn_stats

    c = lambda d: {k: v.detach().double().clone() for k, v in d.items()}  # noqa
    return {"params": c(st.params), "stats": c(bn_stats(st.model)),
            "mu": c(st.opt_state["mu"]), "ema": c(st.ema),
            "counters": (st.step, st.last_opt_step, st.ema_updates)}


def main(coordinator, nproc, rank, case_path, out_path):
    from desenet_tpu_torch.losses import DetectionLoss
    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.parallel import multihost
    from desenet_tpu_torch.train import make_train_step, one_cycle
    from desenet_tpu_torch.train.optim import OptimConfig
    from desenet_tpu_torch.utils.convert import train_state_from_jax

    torch.set_num_threads(1)
    multihost.init_multihost(coordinator, nproc, rank, device="cpu")
    case = torch.load(case_path, weights_only=False)
    model, _ = build_model(case["cfg"], seg_upsample=not case["fused"],
                           train=True)
    f64 = case["f64"]
    if f64:
        model.double()
    pcfg = OptimConfig(**case["opt"])
    state = train_state_from_jax(case["jstate"], model, pcfg)
    step = make_train_step(
        model, DetectionLoss(anchors=case["anchors"], nc=3), pcfg,
        one_cycle(1, 0.2, 10), fused_seg=case["fused"],
        dtype=torch.float64 if f64 else torch.float32, **case["common"])
    rows = multihost.local_batch_slice(case["common"]["batch_size"])
    local = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    out = []
    for _ in range(case["steps"]):
        state, m = step(state, local)
        out.append(({k: float(v) for k, v in m.items()}, snapshot(state)))
    torch.save(out, f"{out_path}.{rank}")
    multihost.sync_hosts("done")
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
