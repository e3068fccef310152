"""Mean host time of one ``Trainer.train_step`` call, from call to return,
over the unprofiled window's steps: the span the benchmark takes around the
call. It holds the host's dispatch and the waits of the step's own
synchronising copies."""


def read(record):
    spans = record["window"]["host_spans_ms"]
    return sum(spans) / len(spans) if spans else None
