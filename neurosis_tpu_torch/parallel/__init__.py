"""Training on more than one card: the process group and the (data, fsdp)
mesh (``mesh``), FSDP2 over it (``fsdp``), and the global batch's draws and
statistics on a rank's rows (``rows``)."""
