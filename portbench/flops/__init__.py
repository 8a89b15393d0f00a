"""Model flops a trained token, by family (``flops/<family>.py``)."""
