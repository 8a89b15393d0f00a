"""The paper's gradient exchange (torch twin of ``repro.collectives``):
``schedules``, the numpy simulators with their cost counters; ``dist``,
the executable all-reduce over ``torch.distributed``; and ``cost``, the
analytic step-time model of eqs. 2-4 at the paper's InfiniBand
coefficients."""
