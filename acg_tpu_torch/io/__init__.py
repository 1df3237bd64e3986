from acg_tpu_torch.io.mtxfile import MtxFile, read_mtx, write_mtx  # noqa: F401
