"""The numpy-in/numpy-out library (color, feature, transform, undistort,
helpers; each runs its tensor ops on a ``device``, cuda:0 unless told
``cpu``) and host helpers: contours, drawing for debug posts, SIFT pose,
tree utilities."""
