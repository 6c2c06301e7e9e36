"""Detector and classifier modules: layers, the MobileNetV3, MobileNetV2,
VGG16 and PeleeNet trunks, the extractors and heads of the five SSD
families, the SSD meta-architecture, the builders and registry, and the
matcher and MultiBox loss that train them."""
