"""Share of the traced stretch of offline serving in which nothing ran on
the card while the host was inside the program's ``predict.pin`` or
``predict.download`` spans: the card idle on the served batch's copies."""

from benchmark.harness.spans import idle_inside_pct

LAYER = "host pre and post (api.Predictor.run_batch, __call__)"
UNIT = "%"
MOVES = "serve_img_s"


def read(rec: dict):
    return idle_inside_pct(rec, ("predict.pin", "predict.download"))
