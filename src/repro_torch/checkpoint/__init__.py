from repro_torch.checkpoint.checkpointer import (latest_step,  # noqa: F401
                                                 latest_valid_step,
                                                 read_meta, read_precision,
                                                 reshard_bucket,
                                                 restore_checkpoint,
                                                 save_checkpoint,
                                                 stray_tmp_files,
                                                 verify_checkpoint)
