"""idle_in_host_work_share (%, lower is better; layer: predicts,
predict/pipeline.py and predict/fcn.py): % of the traced sub-window in
which the card is idle while the thread that holds the engine has
``predict.prepare`` or ``predict.enqueue`` as its innermost span: host
work of the predicts that the card waits for."""

from port_bench.core import spans


def read(run):
    split = spans.idle_split(run)
    if split is None or run.trace.window_s <= 0:
        return None
    return 100.0 * sum(split.get(n, 0.0) for n in spans.HOST_WORK) / run.trace.window_s
