"""Detector modules: layers, MobileNetV3 trunk, SSDLite extractor and
head, the SSD meta-architecture and the builders."""
