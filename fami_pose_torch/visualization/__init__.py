from .draw import draw_bbox, draw_skeleton, draw_skeleton_in_origin_image
