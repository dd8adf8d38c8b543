"""The copies of a served batch: the host's pin copy
(``aten::pin_memory``) and the card's uploads and downloads (the
profiler's ``Memcpy`` events), in ms a batch over the traced batches."""

LAYER = "host pre and post (api.Predictor.run_batch, __call__)"
UNIT = "ms"
MOVES = "serve_img_s"


def read(rec: dict):
    dev = rec.get("device")
    if not dev or not rec.get("calls"):
        return None
    copies = sum(e - s for name, s, e in dev if name.startswith("Memcpy"))
    pins = sum(e - s for name, s, e in rec.get("host", ())
               if name == "aten::pin_memory")
    return (copies + pins) / 1e3 / rec["calls"]
