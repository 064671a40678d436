"""Training (counterpart of ``vfloodnet_tpu.train``): the AFB-URR video
trainer (``train_video``), the LinkNet image trainer (``train_image``),
their loops (``loops``), the Generalized R-CNN trainer
(``train_detection``) and the body-mesh trainer (``train_bodymesh``)."""
from .loops import run_image_training, run_video_training
from .train_image import (ImageTrainConfig, dice_loss, init_image_train_state,
                          init_linknet, iou_metric, make_image_train_step)
from .train_video import (AdamWClip, VideoTrainConfig, init_afb_urr,
                          init_video_train_state, make_lr_schedule,
                          make_video_train_step, video_clip_loss)

__all__ = ["AdamWClip", "ImageTrainConfig", "VideoTrainConfig",
           "dice_loss", "init_afb_urr", "init_image_train_state",
           "init_linknet", "init_video_train_state", "iou_metric",
           "make_image_train_step", "make_lr_schedule",
           "make_video_train_step", "run_image_training",
           "run_video_training", "video_clip_loss"]
