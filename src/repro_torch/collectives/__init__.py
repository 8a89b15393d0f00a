"""The paper's gradient exchange (torch twin of ``repro.collectives``):
``schedules``, the numpy simulators with their cost counters, and
``dist``, the executable all-reduce over ``torch.distributed``. The
analytic cost model (``repro.collectives.cost``) is not ported yet."""
