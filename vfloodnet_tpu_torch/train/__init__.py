"""Training (counterpart of ``vfloodnet_tpu.train``): the AFB-URR video
trainer (``train_video``) and its loop (``loops``)."""
from .loops import run_video_training
from .train_video import (AdamWClip, VideoTrainConfig, init_afb_urr,
                          init_video_train_state, make_lr_schedule,
                          make_video_train_step, video_clip_loss)

__all__ = ["AdamWClip", "VideoTrainConfig", "init_afb_urr",
           "init_video_train_state", "make_lr_schedule",
           "make_video_train_step", "run_video_training", "video_clip_loss"]
