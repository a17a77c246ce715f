"""Tracking-loss recovery: an explicit state machine with relocalization
(a copy of kinfu_tpu/mapping/relocalize.py, which is numpy only).

The reference's entire failure story is: ICP singular -> print "tracking
fail!" -> wipe the volume and pose history and start over
(icp_registration.cpp:35-37, kinectfusion.cpp:97-102). Here tracking loss
transitions into a LOST state that first tries to re-acquire the existing
map — seeding ICP from stored keyframe poses against the current frame —
and only resets the map after `max_attempts` consecutive failures.
SURVEY.md section 5 calls this out as a required aux subsystem.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class TrackingStatus(enum.Enum):
    OK = "ok"
    LOST = "lost"
    RESET = "reset"


@dataclass
class RelocalizerConfig:
    #: consecutive relocalization attempts before giving up and resetting
    max_attempts: int = 5
    #: minimum ICP-inlier FRACTION of the image pixels for a relocalization
    #: to count as re-acquired (resolution-relative; ~2000 px at 640x480)
    min_inlier_frac: float = 2000.0 / (640 * 480)
    #: absolute override; None = round(min_inlier_frac * num_pixels)
    min_inliers: int | None = None


@dataclass
class Relocalizer:
    """The host-side policy. The device-side step stays pure; the
    session consults this object to decide what to feed it next."""

    config: RelocalizerConfig = field(default_factory=RelocalizerConfig)
    status: TrackingStatus = TrackingStatus.OK
    failed_attempts: int = 0
    #: image pixel count at the tracked resolution (set by the session)
    num_pixels: int = 640 * 480

    @property
    def inlier_threshold(self) -> int:
        if self.config.min_inliers is not None:
            return self.config.min_inliers
        return max(1, round(self.config.min_inlier_frac * self.num_pixels))

    def on_frame(self, tracking_ok: bool, icp_inliers: int) -> TrackingStatus:
        """Update the state machine with one frame's result; the returned
        status tells the caller what happened:

          OK    -- tracking (or relocalization) succeeded
          LOST  -- lost; caller should seed the next attempt from a
                   keyframe pose (KeyframeStore.nearest) and NOT integrate
          RESET -- attempts exhausted; caller wipes map + history
        """
        if tracking_ok and (
            self.status is TrackingStatus.OK
            or icp_inliers >= self.inlier_threshold
        ):
            self.status = TrackingStatus.OK
            self.failed_attempts = 0
            return self.status

        self.failed_attempts += 1
        if self.failed_attempts > self.config.max_attempts:
            self.status = TrackingStatus.RESET
            self.failed_attempts = 0
        else:
            self.status = TrackingStatus.LOST
        return self.status
