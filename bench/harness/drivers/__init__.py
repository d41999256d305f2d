"""Drivers: how a configuration's program is opened, fed and read back
(``"driver"`` in a configuration file).  A driver module holds a class
``Driver`` with:

- ``Driver(config, traffic, seed, device, inputs)``: opens the program and
  checks that what it allocated is what the configuration states;
- ``warm_up()``: the traffic's warm-up, counted as set-up;
- ``step(due_ns=None) -> [Span]``: hands the next unit of work (and what
  the mix asks after it) and returns a span a call; an event's latency
  counts from ``due_ns`` (``time.perf_counter_ns``), by default the handing;
- ``counters() -> dict``: the program's own counters and the driver's
  (``edges`` acknowledged, ``batches`` handed);
- ``latencies_ms() -> [float]``: every event's latency so far;
- ``outputs()``: what the reference named by the configuration judges;
- ``close()``: frees the program's state."""
