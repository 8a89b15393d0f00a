"""One reader a per-layer metric: ``<metric>.py`` defines ``read(traces)``,
which takes each rank's traced-window summary (``trace.summarize`` and the
harness's additions) and returns the metric's value, or None when it finds
nothing to read. A kernel's roofline reader also declares the kernel for
the traced window to record: ``ENTRY`` (module, name of its entry point),
``KERNEL`` (the substring of its device kernels' names) and
``describe(*args, **kwargs)``, a call's shapes as its formula takes them."""
