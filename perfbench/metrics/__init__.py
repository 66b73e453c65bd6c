"""One reader per metric, found by the metric's name (`<name>.py`), and the
operation and byte counts they share (`counts.py`)."""
