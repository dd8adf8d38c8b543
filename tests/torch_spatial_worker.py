"""One process of the spatial-partitioning tests' runs on the CPU (gloo).

    python tests/torch_spatial_worker.py <coordinator> <nproc> <rank>
        <case.pt> <out.pt>

Four processes. On a ``dp1 x sp4`` mesh (bands of 2, 2, 2 and 1 strides of
a 7-stride map: uneven, and a 13x13 pool's halo of 6 rows spans three
bands) and on a ``dp2 x sp2`` one, each primitive of
``parallel/spatial.py`` and each band op of ``ops/resize.py`` and
``models/layers.py`` runs on this rank's band of a seeded float64 map,
forward and backward (a seeded weight on the output), against the same op
on the whole map in this process. Then, on ``dp2 x sp2``, tiny_psp2's
eval forward at 128 px of this data row's images (f32 on the JAX
package's init weights, float64 on served weights, and f32 with the seg
head as kernel K4), and one float64
training step of a global batch from the JAX state in ``case.pt``
(``tests/torch_dist_worker.py``'s case). Writes its results to
``out.pt.<rank>``. Imports torch and the port only.
"""

import sys

import torch
import torch.nn.functional as F

H_BANDS = 7  # strides of the primitives' map


def op_cases():
    """name -> (whole-map op, band op, stride factor of the map, output):
    ops of NCHW float64 maps, whose output is ``"band"`` (this rank's rows
    of the whole output), ``"whole"`` (on every rank) or ``("halo", top,
    bottom)`` (the band and its halo rows)."""
    import copy

    from desenet_tpu_torch.models.layers import BatchNorm2d, Conv2d
    from desenet_tpu_torch.ops import resize as R
    from desenet_tpu_torch.parallel import spatial

    def conv(k, s, p, d):
        torch.manual_seed(k * 100 + s * 10 + d)
        c = Conv2d(3, 4, k, s, p, dilation=d).double()
        return lambda t: F.conv2d(t, c.weight, c.bias, s, p, d), c

    def bn():
        torch.manual_seed(7)
        m = BatchNorm2d(3, eps=1e-3, momentum=0.03).double().train()
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5)
            m.bias.uniform_(-0.5, 0.5)
        return m, copy.deepcopy(m)

    def up(k):
        return lambda t: F.interpolate(t, scale_factor=k, mode="bilinear",
                                       align_corners=True)

    return {
        "halo": (lambda t: F.pad(t, (0, 0, 1, 2)),
                 lambda t: spatial.halo(t, 1, 2), 4, ("halo", 1, 2)),
        "halo_wide": (lambda t: F.pad(t, (0, 0, 5, 4), value=-1.0),
                      lambda t: spatial.halo(t, 5, 4, -1.0), 1,
                      ("halo", 5, 4)),
        "gather_rows": (lambda t: t, spatial.gather_rows, 4, "whole"),
        "conv3": (*conv(3, 1, 1, 1), 4, "band"),
        "conv3_s2": (*conv(3, 2, 1, 1), 4, "band"),
        "conv6_s2_stem": (*conv(6, 2, 2, 1), 4, "band"),
        "conv3_dilated3": (*conv(3, 1, 3, 3), 4, "band"),
        "conv5": (*conv(5, 1, 2, 1), 1, "band"),
        "max_pool13": (lambda t: F.max_pool2d(t, 13, 1, 6),
                       lambda t: R.max_pool_same(t, 13), 1, "band"),
        "max_pool5": (lambda t: F.max_pool2d(t, 5, 1, 2),
                      lambda t: R.max_pool_same(t, 5), 4, "band"),
        "global_pool": (lambda t: F.adaptive_avg_pool2d(t, 1),
                        lambda t: R.adaptive_avg_pool(t, 1), 4, "whole"),
        "bins6": (lambda t: F.adaptive_avg_pool2d(t, 6),
                  lambda t: R.adaptive_avg_pool(t, 6), 4, "whole"),
        "bins3": (lambda t: F.adaptive_avg_pool2d(t, 3),
                  lambda t: R.adaptive_avg_pool(t, 3), 1, "whole"),
        "up2": (up(2), lambda t: R.resize_bilinear_band(t, 2), 2, "band"),
        "up4": (up(4), lambda t: R.resize_bilinear_band(t, 4), 1, "band"),
        "pool_up": (lambda t: F.interpolate(
                        F.adaptive_avg_pool2d(t, 3), size=t.shape[2:],
                        mode="bilinear", align_corners=True),
                    lambda t: R.resize_bilinear_onto(
                        R.adaptive_avg_pool(t, 3), t), 4, "band"),
        "batch_norm": (*bn(), 4, "band"),
    }


def _bands(mesh, h):
    """Every spatial rank's rows of an ``h``-row map."""
    from desenet_tpu_torch.parallel.mesh import band_rows

    f = h // H_BANDS
    out = []
    for i in range(mesh.spatial):
        sl = band_rows(32 * H_BANDS, mesh.spatial, i)
        out.append(slice(sl.start // 32 * f, sl.stop // 32 * f))
    return out


def check_op(mesh, name, ref_op, band_op, f, kind):
    """(forward error, input-gradient error) of ``band_op`` on this rank's
    band against ``ref_op`` on the whole map. The backward takes the sum
    over the spatial ranks of their outputs times a seeded weight (a whole
    output's weighted by 1/spatial on each rank, as the training step
    scales its loss); the reference takes the same sum on the whole map."""
    from desenet_tpu_torch.parallel import spatial

    g = torch.Generator().manual_seed(sum(map(ord, name)))
    x = torch.randn(2, 3, H_BANDS * f, 6, generator=g, dtype=torch.float64)
    bands = _bands(mesh, x.shape[2])
    sl = bands[mesh.spatial_index]
    xr = x.clone().requires_grad_(True)
    yr = ref_op(xr)
    w = torch.randn(yr.shape, generator=g, dtype=torch.float64)
    if kind == "whole":
        wins = [slice(None)] * mesh.spatial
        ref_loss = (yr * w).sum()
    elif kind == "band":
        r = yr.shape[2] / x.shape[2]
        wins = [slice(round(b.start * r), round(b.stop * r)) for b in bands]
        ref_loss = (yr * w).sum()
    else:  # the padded map's rows of each band and its halo
        _, top, bot = kind
        wins = [slice(b.start, b.stop + top + bot) for b in bands]
        ref_loss = sum((yr[:, :, v] * w[:, :, v]).sum() for v in wins)
    ref_loss.backward()
    want, wb = yr[:, :, wins[mesh.spatial_index]], w[:, :,
                                                     wins[mesh.spatial_index]]
    if kind == "whole":
        wb = wb / mesh.spatial
    xb = x[:, :, sl].clone().requires_grad_(True)
    with spatial.scope(mesh, 32 * H_BANDS):
        yb = band_op(xb)
        (yb * wb).sum().backward()
    return (float((yb.detach() - want.detach()).abs().max()),
            float((xb.grad - xr.grad[:, :, sl]).abs().max()))


def primitives(meshes):
    out = {}
    for tag, mesh in meshes.items():
        for name, case in op_cases().items():
            out[f"{name}/{tag}"] = check_op(mesh, name, *case)
    return out


def eval_forward(case, mesh, sd_key, dtype, fused=False):
    """The eval forward of this data row's images in ``dtype`` on the
    weights ``case[sd_key]``, on bands (whole outputs) and on this
    process's whole images; ``fused``: the seg head as kernel K4, with
    the number of its calls on bands (``k4_calls``)."""
    from desenet_tpu_torch.models import build as B
    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.parallel import spatial
    from desenet_tpu_torch.parallel.mesh import shard_batch
    from desenet_tpu_torch.utils.convert import load_state_dict

    calls = []
    k4 = B.fused_psp2_eval
    B.fused_psp2_eval = lambda *a, **k: calls.append(1) or k4(*a, **k)
    model, _ = build_model(case["cfg"], seg_upsample=True,
                           seg_head_fused=fused)
    load_state_dict(model, {k: torch.from_numpy(v)
                            for k, v in case[sd_key].items()})
    model.to(dtype).eval()
    imgs = torch.from_numpy(case["eval_images"]).to(dtype)  # (B, H, W, 3)
    rows = shard_batch({"image": imgs}, data_axis(mesh))["image"]
    mine = shard_batch({"image": imgs}, mesh)["image"]
    with torch.no_grad():
        with spatial.scope(mesh, imgs.shape[1]):
            (dec, _), seg = model(mine.permute(0, 3, 1, 2).contiguous())
        k4_calls = len(calls)
        (dec1, _), seg1 = model(rows.permute(0, 3, 1, 2).contiguous())
    B.fused_psp2_eval = k4
    return {"dec": dec.numpy(), "seg": seg.permute(0, 2, 3, 1).numpy(),
            "k4_calls": k4_calls,
            "dec_whole": dec1.numpy(),
            "seg_whole": seg1.permute(0, 2, 3, 1).numpy(),
            "rows": list(range(mesh.data_index * mine.shape[0],
                               (mesh.data_index + 1) * mine.shape[0])),
            "band": tuple(mine.shape)}


def data_axis(mesh):
    """``mesh``'s data axis alone (this rank's whole images)."""
    from desenet_tpu_torch.parallel.mesh import Mesh

    return Mesh(mesh.n_data, 1, mesh.data_index)


def train_step(case, mesh):
    from desenet_tpu_torch.losses import DetectionLoss
    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.parallel.multihost import local_batch_slice
    from desenet_tpu_torch.train import make_train_step, one_cycle
    from desenet_tpu_torch.train.optim import OptimConfig
    from desenet_tpu_torch.utils.convert import train_state_from_jax
    from torch_dist_worker import snapshot

    model, _ = build_model(case["cfg"], seg_upsample=not case["fused"],
                           train=True)
    model.double()
    pcfg = OptimConfig(**case["opt"])
    state = train_state_from_jax(case["jstate"], model, pcfg)
    step = make_train_step(
        model, DetectionLoss(anchors=case["anchors"], nc=3), pcfg,
        one_cycle(1, 0.2, 10), fused_seg=case["fused"], dtype=torch.float64,
        mesh=mesh, **case["common"])
    rows = local_batch_slice(case["common"]["batch_size"], mesh.data_index,
                             mesh.n_data)
    local = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    state, m = step(state, local)
    return {k: float(v) for k, v in m.items()}, snapshot(state)


def main(coordinator, nproc, rank, case_path, out_path):
    from desenet_tpu_torch.parallel import multihost
    from desenet_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    multihost.init_multihost(coordinator, nproc, rank, device="cpu")
    case = torch.load(case_path, weights_only=False)
    meshes = {"dp1xsp4": make_mesh(nproc, spatial=4),
              "dp2xsp2": make_mesh(nproc, spatial=2)}
    out = {"primitives": primitives(meshes),
           "forward": eval_forward(case, meshes["dp2xsp2"], "eval_sd",
                                   torch.float32),
           "forward64": eval_forward(case, meshes["dp2xsp2"], "served_sd",
                                     torch.float64),
           "forward_k4": eval_forward(case, meshes["dp2xsp2"], "eval_sd",
                                      torch.float32, fused=True),
           "step": train_step(case, meshes["dp2xsp2"])}
    torch.save(out, f"{out_path}.{rank}")
    multihost.sync_hosts("done")
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
