"""Detector modules: layers, MobileNetV3 trunk, SSDLite extractor and
head, the SSD meta-architecture, the builders, and the matcher and
MultiBox loss that train them."""
