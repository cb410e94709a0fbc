"""selected_page_ratio.scan: EngineStats selected_pages over table_pages_seen in the traced part, %."""
from pb_readers import selected_page_ratio as read  # noqa: F401
