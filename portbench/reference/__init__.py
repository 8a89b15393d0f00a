"""Plain f32 PyTorch references of the benchmark's model families: no
kernel, no cache, nothing of the program. ``<family>.py`` gives the
parameter layout and the loss with its gradient; ``_common`` the AdamW
steps and the readings the comparison reads."""
