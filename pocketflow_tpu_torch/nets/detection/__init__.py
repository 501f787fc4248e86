"""Detection pieces: anchors and matching, the SSD loss, the Faster R-CNN
proposal layer, ROI-align, targets and losses, host NMS and VOC mAP."""
