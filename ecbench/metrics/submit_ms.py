"""submit_ms.<cell's traffic>: host ms an encode_batch_words call takes
to return, from the harness's own span around it (the card works on after
it)."""


def read(run):
    spans = run.spans.get("submit")
    if not spans:
        return None
    return sum(t1 - t0 for t0, t1 in spans) / len(spans) * 1e3
