"""The image front end (port of ``xivo_tpu/frontend``): FAST detection,
BRIEF descriptors, pyramidal LK and the image-mode frame step."""
