"""The benchmark of demonet_tpu_torch: a run's set-up, measured window,
traced window and the comparison that decides `correct` (`runner`), and
what they share."""
