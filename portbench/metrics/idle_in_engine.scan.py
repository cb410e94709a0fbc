"""idle_in_engine.scan: share of the traced window in which the device idles inside the program's hippo.engine.batch spans (run_batch), %."""
from pb_spans import idle_in_engine as read  # noqa: F401
