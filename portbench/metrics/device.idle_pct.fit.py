"""The share of the traced window in which no operation runs on the card,
%, in the fit cells."""

from portbench.tracing import idle_pct


def read(run):
    return idle_pct(run.get("trace"))
