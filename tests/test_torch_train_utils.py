"""The port's training host utilities against the JAX package's, on the
CPU: autoanchor (the same anchors and ``changed`` flag from the same seed
and labels), the ``utils/general.py`` additions (seeds, the latest run,
class and image weights, early stopping), the callback registry, the
results.csv logger and the port's copy of the fake-dataset writer."""

import os
import random
import sys
import types

import numpy as np
import pytest

from desenet_tpu.utils import autoanchor as jax_aa
from desenet_tpu.utils import callbacks as jax_cb
from desenet_tpu.utils import general as jax_general
from desenet_tpu.utils import loggers as jax_loggers
from desenet_tpu_torch.utils import autoanchor as port_aa
from desenet_tpu_torch.utils import callbacks as port_cb
from desenet_tpu_torch.utils import general as port_general
from desenet_tpu_torch.utils import loggers as port_loggers

HERE = os.path.dirname(os.path.abspath(__file__))
ANCHORS = np.asarray([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                      [116, 90, 156, 198, 373, 326]],
                     np.float32).reshape(3, 3, 2)
STRIDES = (8, 16, 32)


def labelled(seed, n, elongated):
    """A dataset stand-in: image shapes (w, h) and det labels [cls, xywhn];
    elongated boxes make the default anchors' BPR fall under 0.98."""
    rng = np.random.default_rng(seed)
    shapes = rng.integers(200, 900, (n, 2)).astype(np.float32)
    labels = []
    for _ in range(n):
        m = int(rng.integers(0, 6))
        wh = rng.uniform(0.01, 0.4, (m, 2))
        if elongated:
            wh[:, 0] = rng.uniform(0.5, 0.9, m)
            wh[:, 1] = rng.uniform(0.004, 0.02, m)
        labels.append(np.concatenate([rng.integers(0, 3, (m, 1)),
                                      rng.uniform(0.2, 0.8, (m, 2)), wh],
                                     1).astype(np.float32))
    return types.SimpleNamespace(shapes=shapes, det_labels=labels)


@pytest.mark.parametrize("seed,elongated", [(0, False), (1, True),
                                            (2, True), (3, False)])
def test_check_anchors_equal(seed, elongated):
    ds = labelled(seed, 40, elongated)
    got = port_aa.check_anchors(ds, ANCHORS, STRIDES, thr=4.0, imgsz=640,
                                seed=seed)
    want = jax_aa.check_anchors(ds, ANCHORS, STRIDES, thr=4.0, imgsz=640,
                                seed=seed)
    assert got[1] == want[1] == elongated
    np.testing.assert_array_equal(got[0], want[0])


def test_too_few_labels_keep_the_anchors():
    ds = labelled(5, 3, True)  # under 9 labels: k-means is refused
    got = port_aa.check_anchors(ds, ANCHORS, STRIDES, seed=5)
    want = jax_aa.check_anchors(ds, ANCHORS, STRIDES, seed=5)
    assert got[1] is want[1] is False
    np.testing.assert_array_equal(got[0], ANCHORS)
    with pytest.raises(ValueError, match="labels"):
        port_aa.kmean_anchors(ds.shapes, ds.det_labels, n=9, seed=5)


@pytest.mark.parametrize("seed", [0, 1])
def test_anchor_pieces_equal(seed):
    ds = labelled(seed, 30, bool(seed))
    rng = (np.random.default_rng(seed), np.random.default_rng(seed))
    wh = port_aa.dataset_wh(ds.shapes, ds.det_labels, 320, rng[0])
    np.testing.assert_array_equal(
        wh, jax_aa.dataset_wh(ds.shapes, ds.det_labels, 320, rng[1]))
    flat = ANCHORS.reshape(-1, 2)
    assert port_aa.anchor_fitness(flat, wh, 0.25) == \
        jax_aa.anchor_fitness(flat, wh, 0.25)
    np.testing.assert_array_equal(port_aa._lloyd_kmeans(wh / wh.std(0), 9,
                                                        seed=seed),
                                  jax_aa._lloyd_kmeans(wh / wh.std(0), 9,
                                                       seed=seed))
    np.testing.assert_array_equal(
        port_aa.kmean_anchors(ds.shapes, ds.det_labels, gen=200, seed=seed),
        jax_aa.kmean_anchors(ds.shapes, ds.det_labels, gen=200, seed=seed))
    for a, s in ((ANCHORS, STRIDES), (ANCHORS, STRIDES[::-1])):
        np.testing.assert_array_equal(port_aa.check_anchor_order(a, s),
                                      jax_aa.check_anchor_order(a, s))


def test_init_seeds_seeds_what_the_jax_package_does():
    gen = port_general.init_seeds(7)
    got = (random.random(), np.random.random())
    jax_general.init_seeds(7)
    assert got == (random.random(), np.random.random())
    import torch

    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(7)))


def test_latest_run_and_weights_equal(tmp_path):
    for i, name in enumerate(("a/exp/last", "b/exp2/last", "c/last2")):
        d = tmp_path / name
        d.mkdir(parents=True)
        (d / "meta.json").write_text("{}")
        os.utime(d / "meta.json", (1e9 + i, 1e9 + i))
    assert port_general.get_latest_run(str(tmp_path)) == \
        jax_general.get_latest_run(str(tmp_path)) == \
        str(tmp_path / "b/exp2/last")
    assert port_general.get_latest_run(str(tmp_path / "none")) == ""
    ds = labelled(3, 12, False)
    for nc in (3, 5):
        cw = port_general.labels_to_class_weights(ds.det_labels, nc)
        np.testing.assert_array_equal(
            cw, jax_general.labels_to_class_weights(ds.det_labels, nc))
        np.testing.assert_array_equal(
            port_general.labels_to_image_weights(ds.det_labels, nc, cw),
            jax_general.labels_to_image_weights(ds.det_labels, nc, cw))
    np.testing.assert_array_equal(port_general.labels_to_class_weights([], 4),
                                  jax_general.labels_to_class_weights([], 4))


@pytest.mark.parametrize("patience", [0, 1, 3])
def test_early_stopping_equal(patience):
    fits = [0.1, 0.3, 0.2, 0.2, 0.25, 0.3, 0.1, 0.05, 0.0, 0.4]
    got, want = port_general.EarlyStopping(patience), \
        jax_general.EarlyStopping(patience)
    assert [got(e, f) for e, f in enumerate(fits)] == \
        [want(e, f) for e, f in enumerate(fits)]
    assert (got.best_epoch, got.best_fitness) == (want.best_epoch,
                                                  want.best_fitness)


def test_callbacks_equal():
    assert port_cb.HOOKS == jax_cb.HOOKS
    runs = []
    for mod in (port_cb, jax_cb):
        cb = mod.Callbacks()
        seen = []

        class Sink:
            def on_fit_epoch_end(self, row):
                seen.append(("fit", row))

            def teardown(self):
                seen.append(("teardown",))

        cb.auto_register(Sink())
        cb.register_action("on_train_start", "x", lambda: seen.append(("s",)))
        for hook in mod.HOOKS:
            cb.run(hook, {"epoch": 1}) if hook == "on_fit_epoch_end" \
                else cb.run(hook)
        runs.append((seen, {h: [a["name"] for a in v] for h, v in
                            cb.get_registered_actions().items()}))
    assert runs[0] == runs[1]
    cb = port_cb.Callbacks()
    with pytest.raises(KeyError, match="not in"):
        cb.run("on_nothing")
    with pytest.raises(TypeError, match="callable"):
        cb.register_action("teardown", callback=3)


def test_results_csv_equal(tmp_path):
    assert port_loggers.CSV_KEYS == jax_loggers.CSV_KEYS
    rows = [{k: float(i + j) / 7 for j, k in enumerate(
        port_loggers.CSV_KEYS)} for i in range(3)]
    rows[1].pop("metrics/mIoU")
    texts = []
    for mod, d in ((port_loggers, tmp_path / "p"), (jax_loggers,
                                                    tmp_path / "j")):
        log = mod.Loggers(str(d), use_tb=False)
        for r in rows:
            log.on_fit_epoch_end(dict(r, epoch=int(r["epoch"] * 7)))
        log.on_train_end()
        log.teardown()
        texts.append((d / "results.csv").read_text())
    assert texts[0] == texts[1] and texts[0].count("\n") == 4


def test_fake_dataset_copy_equals_the_tool(tmp_path):
    pytest.importorskip("cv2", reason="the fake dataset is written with cv2")
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    from make_fake_dataset import generate as tool_generate

    from desenet_tpu_torch.tools.make_fake_dataset import generate

    got = generate(str(tmp_path / "p"), n_train=3, n_val=2, size=48, seed=2)
    want = tool_generate(str(tmp_path / "t"), n_train=3, n_val=2, size=48,
                         seed=2)
    files = sorted(os.path.relpath(os.path.join(b, n), tmp_path / "t")
                   for b, _, ns in os.walk(tmp_path / "t") for n in ns)
    assert len(files) == 16
    for f in files:
        if f != "data.yaml":
            assert (tmp_path / "p" / f).read_bytes() == \
                (tmp_path / "t" / f).read_bytes(), f
    a, b = port_general.check_dataset(got), jax_general.check_dataset(want)
    assert {k: v for k, v in a.items() if k not in ("train", "val")} == \
        {k: v for k, v in b.items() if k not in ("train", "val")}
    assert a["train"] == str(tmp_path / "p" / "Images" / "train")


def test_load_yaml_reads_json_without_pyyaml(tmp_path, monkeypatch):
    path = tmp_path / "x.yaml"
    path.write_text('{"a": [1, 2], "b": {"c": "d"}}')
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert port_general.load_yaml(str(path)) == {"a": [1, 2],
                                                 "b": {"c": "d"}}
    path.write_text("a: 1\n")
    with pytest.raises(ImportError):
        port_general.load_yaml(str(path))
